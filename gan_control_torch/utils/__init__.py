"""Config, logging, device, checkpoint and flax-parameter utilities."""
