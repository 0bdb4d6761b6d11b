"""GAN inversion (port of ``gan_control_tpu/projection``): the LPIPS
perceptual distance and the latent optimisation that projects an image into
w+ (``python -m gan_control_torch.project``)."""

from gan_control_torch.projection.lpips import LPIPS, lpips_distance, make_lpips
from gan_control_torch.projection.projection import (
    Projector,
    get_avg_latent,
    get_lr,
    get_pca_groups,
    latent_noise,
    make_image,
    noise_normalize,
    noise_regularize,
    project,
)

__all__ = ["LPIPS", "Projector", "get_avg_latent", "get_lr", "get_pca_groups", "latent_noise",
           "lpips_distance", "make_image", "make_lpips", "noise_normalize", "noise_regularize",
           "project"]
