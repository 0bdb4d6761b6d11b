"""Data loaders (port of ``gan_control_tpu.data``)."""
