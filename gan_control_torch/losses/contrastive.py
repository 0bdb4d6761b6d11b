"""The contrastive disentanglement criterion (port of
``gan_control_tpu/losses/contrastive.py``).

Given per-layer features of a mini-batch arranged as [same-group pairs ++
other pairs] (rows 2i, 2i+1 are a pair), the loss is, per layer:

    dist     = pairwise distance matrix over all rows
    same     = entries of adjacent pairs inside the "same" block
    not_same = every other strictly-lower-triangular entry
    loss     = mean(clamp(same - lower_thres, 0)) + mean(clamp(upper_thres - not_same, 0))

``focus_on`` per layer flips which side a layer pulls together:
'same_as_last_layer' pulls the same-group pairs under lower_thres and pushes
everything else above upper_thres; 'not_same_as_last_layer' does the
reverse. The masks are static: they and their counts come from the
mini-batch arrangement, so each mean is ``sum(x * mask) / count``.
``contrastive_loss_masked`` (the randomized mini-batch mode) takes the pair
masks as tensors, fresh each step, with the features in batch order.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Sequence

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Pairwise distances (one per criterion of the reference)
# ---------------------------------------------------------------------------


def pairwise_sq_l2(a: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """[N,M] squared-L2 matrix (ArcFace)."""
    b = a if b is None else b
    return torch.sum(torch.square(a[:, None] - b[None, :]), dim=-1)


def pairwise_l1(a: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """[N,M] mean |diff| over every trailing feature axis (Hopenet, DEX,
    ESR-9, the 3DMM coefficients)."""
    b = a if b is None else b
    diff = a[:, None] - b[None, :]
    return torch.mean(torch.abs(diff), dim=tuple(range(2, diff.ndim)))


def pairwise_mse_gram(a: torch.Tensor, b: torch.Tensor | None = None,
                      gain: float = 1e5) -> torch.Tensor:
    """[N,M] MSE over gram-matrix features times 1e5 (the style criterion)."""
    b = a if b is None else b
    diff = a[:, None] - b[None, :]
    return torch.mean(torch.square(diff), dim=tuple(range(2, diff.ndim))) * gain


def pairwise_hair_color(a: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """Hair-color distance. Features are NHWC [N, H, W, 4]: the masked RGB
    image (3) ++ the mask (1). The distance is the mean |diff| of each
    image's mean hair color (mapped to [0, 1]), zero where either image has
    fewer than 1 % hair pixels. The mask sum takes no gradient."""
    b = a if b is None else b

    def mean_color_and_valid(f):
        h, w = f.shape[1], f.shape[2]
        masked_img, mask = f[..., :3], f[..., 3:]
        mask_sum = torch.sum(mask.detach(), dim=(1, 2))  # [N,1]
        valid = mask_sum > 0.01 * h * w
        color = torch.sum(masked_img, dim=(1, 2)) / (mask_sum + (mask_sum < 0.5).to(mask_sum.dtype))
        return color * 0.5 + 0.5, valid

    ca, va = mean_color_and_valid(a)
    cb, vb = mean_color_and_valid(b)
    valid_uv = va[:, None, 0] & vb[None, :, 0]
    diff = (ca[:, None] - cb[None, :]) * valid_uv[..., None].to(ca.dtype)
    return torch.mean(torch.abs(diff), dim=-1)


# ---------------------------------------------------------------------------
# Static masks
# ---------------------------------------------------------------------------


def strict_lower_mask(n: int) -> np.ndarray:
    """Strictly-lower-triangular validity mask."""
    return np.tril(np.ones((n, n), dtype=bool), k=-1)


def same_pair_mask(num_same_pairs: int, n: int) -> np.ndarray:
    """(2i+1, 2i) entries of the pairs in the same-group block."""
    m = np.zeros((n, n), dtype=bool)
    for i in range(num_same_pairs):
        m[2 * i + 1, 2 * i] = True
    return m & strict_lower_mask(n)


def not_same_pair_mask(num_same_pairs: int, num_other_pairs: int, n: int) -> np.ndarray:
    """(2i+1, 2i) entries of the other groups' pairs."""
    m = np.zeros((n, n), dtype=bool)
    for i in range(num_same_pairs, num_same_pairs + num_other_pairs):
        m[2 * i + 1, 2 * i] = True
    return m & strict_lower_mask(n)


@functools.lru_cache(maxsize=None)
def _pull_push_masks(n_same: int, n_not: int, focus: str, device: torch.device):
    """(pull mask, its count, push mask, its count) for one layer's focus,
    on ``device``. Cached: a step reads them without a host-to-device copy
    after the first. Unbounded: a captured battery
    (``losses/battery_graph.py``) reads these masks at every replay without
    holding them, so no entry may be evicted."""
    n = n_same + n_not
    valid = strict_lower_mask(n)
    if focus == "same_as_last_layer":
        pull = same_pair_mask(n_same // 2, n)
    elif focus == "not_same_as_last_layer":
        pull = not_same_pair_mask(n_same // 2, n_not // 2, n)
    else:
        raise ValueError(f"focus_on = {focus}")
    push = ~pull & valid
    return (torch.as_tensor(pull, device=device), max(int(pull.sum()), 1),
            torch.as_tensor(push, device=device), max(int(push.sum()), 1))


# ---------------------------------------------------------------------------
# The criterion
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ContrastiveConfig:
    """Per-loss contrastive hyper-parameters (one JSON loss block, e.g.
    configs/ffhq.json embedding_loss: weights, thresholds, focus)."""

    intermediate_weights: tuple[float, ...]
    last_layer_weight: float
    lower_thres: tuple[float, ...]
    upper_thres: tuple[float, ...]
    last_lower_thres: float
    last_upper_thres: float
    focus_on: tuple[str, ...]  # len == len(intermediate_weights) + 1
    intermediate_as_last: bool = False  # style_loss: gram criterion everywhere

    @property
    def weights(self) -> tuple[float, ...]:
        return self.intermediate_weights + (self.last_layer_weight,)

    @classmethod
    def from_json(cls, cfg: dict) -> "ContrastiveConfig":
        return cls(
            intermediate_weights=tuple(cfg["intermediate_layers_weights"]),
            last_layer_weight=cfg["last_layer_weight"],
            lower_thres=tuple(cfg["lower_thres"]),
            upper_thres=tuple(cfg["upper_thres"]),
            last_lower_thres=cfg["last_lower_thres"],
            last_upper_thres=cfg["last_upper_thres"],
            focus_on=tuple(cfg["focus_on_list"]),
            intermediate_as_last=bool(cfg.get("intermediate_criterion_as_last_layer", False)),
        )


def contrastive_loss(
    cfg: ContrastiveConfig,
    same_features: Sequence[torch.Tensor],
    not_same_features: Sequence[torch.Tensor],
    last_layer_dist: Callable[[torch.Tensor], torch.Tensor],
) -> torch.Tensor:
    """The mini-batch contrastive loss, a scalar.

    ``same_features``: per-layer features of the rows whose even/odd pairs
    share the target group's sub-latent; ``not_same_features``: those of
    every other row. ``last_layer_dist`` maps the last layer's features
    (and every layer's with ``cfg.intermediate_as_last``) to an [N,N]
    distance matrix; the other layers use :func:`pairwise_l1`.
    """
    n_layers = len(same_features)
    if len(cfg.weights) != n_layers:
        raise ValueError(f"{len(cfg.weights)} layer weights for {n_layers} feature layers")
    n_same = same_features[0].shape[0]
    n_not = not_same_features[0].shape[0]
    device = same_features[0].device

    total = torch.zeros((), dtype=torch.float32, device=device)
    for li in range(n_layers):
        w = cfg.weights[li]
        if w == 0:
            continue
        feats = torch.cat([same_features[li], not_same_features[li]], dim=0)
        is_last = li == n_layers - 1
        dist = last_layer_dist(feats) if is_last or cfg.intermediate_as_last else pairwise_l1(feats)
        lo = cfg.last_lower_thres if is_last else cfg.lower_thres[li]
        hi = cfg.last_upper_thres if is_last else cfg.upper_thres[li]
        pull_m, n_pull, push_m, n_push = _pull_push_masks(n_same, n_not, cfg.focus_on[li], device)
        # torch.maximum splits the gradient at a tie, as jnp.maximum does
        zero = dist.new_zeros(())
        pull = torch.sum(torch.maximum(dist - lo, zero) * pull_m.to(dist.dtype)) / n_pull
        push = torch.sum(torch.maximum(hi - dist, zero) * push_m.to(dist.dtype)) / n_push
        total = total + w * (pull + push)
    return total


def contrastive_loss_masked(
    cfg: ContrastiveConfig,
    features: Sequence[torch.Tensor],
    last_layer_dist: Callable[[torch.Tensor], torch.Tensor],
    same_pairs: torch.Tensor,
    not_same_pairs: torch.Tensor,
) -> torch.Tensor:
    """:func:`contrastive_loss` with the pair bookkeeping as [n, n] bool
    masks (``same_pairs``: the target group's pairs; ``not_same_pairs``:
    the pairs of the rows outside them) over ``features`` in batch order.
    Every distance is symmetric, so counting each unordered row pair once
    (the strict lower triangle) equals the static reorder-then-triangle
    bookkeeping. A mean over an empty mask is 0."""
    n_layers = len(features)
    if len(cfg.weights) != n_layers:
        raise ValueError(f"{len(cfg.weights)} layer weights for {n_layers} feature layers")
    n = features[0].shape[0]
    device = features[0].device
    valid = torch.as_tensor(strict_lower_mask(n), device=device)
    same_pairs = torch.as_tensor(same_pairs, device=device) & valid
    not_same_pairs = torch.as_tensor(not_same_pairs, device=device) & valid

    def masked_mean(x, mask):
        m = mask.to(x.dtype)
        return torch.sum(x * m) / torch.clamp(torch.sum(m), min=1.0)

    total = torch.zeros((), dtype=torch.float32, device=device)
    for li in range(n_layers):
        w = cfg.weights[li]
        if w == 0:
            continue
        is_last = li == n_layers - 1
        dist = last_layer_dist(features[li]) if is_last or cfg.intermediate_as_last \
            else pairwise_l1(features[li])
        lo = cfg.last_lower_thres if is_last else cfg.lower_thres[li]
        hi = cfg.last_upper_thres if is_last else cfg.upper_thres[li]
        focus = cfg.focus_on[li]
        if focus == "same_as_last_layer":
            pull_m, push_m = same_pairs, valid & ~same_pairs
        elif focus == "not_same_as_last_layer":
            pull_m, push_m = not_same_pairs, valid & ~not_same_pairs
        else:
            raise ValueError(f"focus_on[{li}] = {focus}")
        zero = dist.new_zeros(())
        pull = masked_mean(torch.maximum(dist - lo, zero), pull_m)
        push = masked_mean(torch.maximum(hi - dist, zero), push_m)
        total = total + w * (pull + push)
    return total
