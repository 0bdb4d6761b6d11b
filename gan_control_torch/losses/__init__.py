"""The contrastive attribute losses and their frozen predictor battery."""
