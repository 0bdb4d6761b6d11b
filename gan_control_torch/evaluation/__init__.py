"""Evaluation (port of ``gan_control_tpu.evaluation``): the sample grids and
per-group matrices that the trainer saves."""
