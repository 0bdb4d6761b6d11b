"""Disentanglement score (DS) (port of
``gan_control_tpu/evaluation/disentanglement.py``).

For a varied group i, sets of images are generated in which every latent
group but i is frozen per set; each attribute's spread within a set (the
mean all-vs-all L2 distance of its predicted values) is normalised by its
spread over free sampling and averaged over the sets. DS_i is high when
varying u_i moves attribute i a lot and every other attribute little.
"""

from __future__ import annotations

from typing import Callable, Mapping, Sequence

import numpy as np
import torch


def all_vs_all_mean_distance(vecs) -> float:
    """Mean pairwise L2 distance over the strictly lower triangle."""
    vecs = np.asarray(vecs, np.float64)
    d2 = np.sum((vecs[:, None] - vecs[None, :]) ** 2, axis=-1)
    d = np.sqrt(np.maximum(d2, 0))
    mask = np.tril(np.ones(len(vecs), dtype=bool), -1)
    return float(d[mask].mean())


def disentanglement_scores(
    generate_fn: Callable[[torch.Tensor], torch.Tensor],
    attribute_fns: Mapping[str, Callable[[torch.Tensor], np.ndarray]],
    group_slices: Mapping[str, tuple[int, int]],
    generator: torch.Generator | None = None,
    num_sets: int = 10,
    set_size: int = 20,
    style_dim: int = 512,
    baseline: Mapping[str, float] | None = None,
    free_z: torch.Tensor | None = None,
    set_latents: Mapping[str, Sequence[torch.Tensor]] | None = None,
) -> dict[str, dict[str, float]]:
    """{varied group: {attribute: normalised spread sigma}}.

    generate_fn: z -> images; attribute_fns: images -> [B, D] values.
    ``baseline``: each attribute's normaliser (the reference's spread over
    real FFHQ images, for numbers comparable with the paper); without it
    the generator's own spread over ``free_z`` ([2 * set_size, style_dim])
    stands in, which can hide an attribute the generator under-covers.
    ``set_latents[group]``: the ``num_sets`` z sets of that group
    ([set_size, style_dim] each). Whatever is not given is drawn from
    ``generator``: ``free_z`` first, then per group and set the frozen
    base z and the varied chunk."""
    if baseline is None:
        if free_z is None:
            free_z = torch.randn((set_size * 2, style_dim), generator=generator)
        imgs = generate_fn(free_z)
        baseline = {name: all_vs_all_mean_distance(fn(imgs)) or 1.0
                    for name, fn in attribute_fns.items()}

    results: dict[str, dict[str, float]] = {}
    for group, (s, e) in group_slices.items():
        spreads: dict[str, list[float]] = {name: [] for name in attribute_fns}
        for j in range(num_sets):
            if set_latents is not None:
                z = set_latents[group][j]
            else:
                base = torch.randn((style_dim,), generator=generator)
                varied = torch.randn((set_size, e - s), generator=generator)
                z = base.expand(set_size, style_dim).clone()
                z[:, s:e] = varied
            imgs = generate_fn(z)
            for name, fn in attribute_fns.items():
                spreads[name].append(all_vs_all_mean_distance(fn(imgs)))
        results[group] = {name: float(np.mean(v) / baseline[name]) for name, v in spreads.items()}
    return results


def ds_index(group_sigmas: Mapping[str, float], own_attribute: str) -> float:
    """DS_i: the product over every other attribute of sigma_own /
    sigma_attr."""
    own = group_sigmas[own_attribute]
    ds = 1.0
    for name, sigma in group_sigmas.items():
        if name != own_attribute:
            ds *= own / sigma
    return float(ds)
