"""Latent group table (port of ``gan_control_tpu.latent``)."""
