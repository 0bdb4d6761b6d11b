"""Evaluation (port of ``gan_control_tpu.evaluation``): sample grids and
matrices, the Tracker, InceptionV3 and FID, separability, the attribute
values and annotations, and the disentanglement score."""
