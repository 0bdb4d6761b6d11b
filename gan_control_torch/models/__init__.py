"""Generator, controller heads and the config-driven factory."""
