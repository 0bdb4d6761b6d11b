"""Trainers (port of ``gan_control_tpu.trainers``): the phase-1
``GeneratorTrainer``."""
