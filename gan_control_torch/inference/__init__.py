"""Inference entry points: ``Inference`` and ``Controller``."""
