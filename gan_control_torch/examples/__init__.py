"""Walkthroughs of the port's inference and serving APIs
(``python -m gan_control_torch.examples.<name> --help``)."""
