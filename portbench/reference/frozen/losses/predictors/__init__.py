"""The frozen predictor networks of the contrastive losses.

Each module holds one network (an ``nn.Module`` that maps NHWC [-1, 1]
images to its list of feature layers, the criterion's embedding last) and:

  - ``make_model(loss_block)``: the network with empty parameters;
  - ``last_layer_dist(features) -> [N, N]``;
  - ``read_reference_state_dict(path)``: the reference checkpoint as a
    ``state_dict`` in the network's names;
  - ``state_dict_from_flax(tree)``: the JAX package's parameter tree as that
    ``state_dict``;
  - ``predict(model, images)``: the attribute value the phase-2 sweep
    writes and ``attribute_rec`` compares, and
    ``controller_criterion(pred, target)``: that comparison.

The six nets of the FFHQ configuration come first; ``vgg_style``,
``dogfacenet`` and ``imagenet_cls`` serve the AFHQ and MetFaces
configurations.
"""

from __future__ import annotations

import importlib
from types import ModuleType

# loss block name -> predictor module
PREDICTOR_MODULES = {
    "embedding_loss": "arcface",
    "orientation_loss": "hopenet",
    "age_loss": "dex_age",
    "expression_loss": "esr9",
    "hair_loss": "hair_pspnet",
    "recon_3d_loss": "face3dmm",
    "style_loss": "vgg_style",
    "dog_id_loss": "dogfacenet",
    "classification_loss": "imagenet_cls",
}


def predictor_module(loss_name: str) -> ModuleType:
    """The predictor module of a loss block (``recon_<sub>_loss`` reads the
    R-Net of ``recon_3d_loss``)."""
    if loss_name.startswith("recon_"):
        loss_name = "recon_3d_loss"
    return importlib.import_module(f"portbench.reference.frozen.losses.predictors.{PREDICTOR_MODULES[loss_name]}")
