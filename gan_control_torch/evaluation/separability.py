"""Separability: how well a latent group's sub-space controls its attribute,
as the gap in a predictor's embedding space between images that share the
group's sub-latent and everything else (port of
``gan_control_tpu/evaluation/separability.py``).

N latents are drawn and the group's chunk copied from each even row to the
odd row after it; per predictor layer the even rows' features are the
signatures and the odd rows' the queries. 'same' is each pair's distance
(the diagonal), 'not_same' each QUERY's closest non-matching signature (a
min over axis 0: the matrix is not symmetric), 'all_not_same' every
non-matching distance.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch


def make_paired_latents(n: int, same_chunk: tuple[int, int], style_dim: int = 512,
                        generator: torch.Generator | None = None,
                        z: torch.Tensor | None = None) -> torch.Tensor:
    """[n, style_dim] z (``z`` or drawn from ``generator``) with
    ``z[1::2, s:e] = z[0::2, s:e]``."""
    s, e = same_chunk
    if z is None:
        z = torch.randn((n, style_dim), generator=generator,
                        device=generator.device if generator is not None else "cpu")
    z = z.clone()
    z[1::2, s:e] = z[0::2, s:e]
    return z


def separability_stats(dist_matrix: np.ndarray) -> dict[str, np.ndarray]:
    """``dist_matrix[i, j] = d(signature_i, query_j)``; pair i <-> i."""
    d = np.asarray(dist_matrix)
    n = d.shape[0]
    off = np.where(np.eye(n, dtype=bool), np.inf, d)
    return {
        "same": np.diag(d).copy(),
        "not_same": off.min(axis=0),
        "all_not_same": d[~np.eye(n, dtype=bool)],
    }


def closest_impostor_pairs(dist_matrix: np.ndarray, k: int = 8) -> np.ndarray:
    """[k, 2] (signature, query) rows: the k queries whose closest
    non-matching signature is nearest, with that signature — the pairs of
    different identities that collapsed together (the "bucket" images)."""
    d = np.asarray(dist_matrix)
    off = np.where(np.eye(d.shape[0], dtype=bool), np.inf, d)
    second = off.min(axis=0)
    sig = off.argmin(axis=0)
    order = np.argsort(second)[: min(k, d.shape[0])]
    return np.stack([sig[order], order], axis=1)


def calc_separability(
    generate_fn: Callable[..., torch.Tensor],
    feature_fn: Callable[[torch.Tensor], Sequence[torch.Tensor]],
    dist_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    seed: int = 0,
    num_of_samples: int = 2000,
    batch_size: int = 20,
    same_chunk: tuple[int, int] = (256, 512),
    style_dim: int = 512,
    last_layer_only: bool = True,
    return_latents: bool = False,
    device: str | torch.device = "cpu",
    latents: torch.Tensor | None = None,
    noise: Sequence[Sequence[torch.Tensor]] | None = None,
):
    """Per layer {'same', 'not_same', 'all_not_same', 'worst_pairs'}
    (``worst_pairs``: :func:`closest_impostor_pairs`); with
    ``return_latents`` also the paired latents, so that the caller can
    generate the worst pairs again.

    generate_fn(z, gen, noise) -> [-1, 1] NHWC images: ``noise`` is the
    batch's entry of ``noise`` (or None), else the injection noise is
    drawn from ``gen``, a FRESH generator per batch on ``device`` seeded
    ``seed * 1_000_003 + 1 + i`` (i the batch's first row). The latents are
    ``latents`` or :func:`make_paired_latents` drawn from a CPU generator
    seeded ``seed``. feature_fn: images -> per-layer features; dist_fn:
    (signatures, queries) -> [N, M] (the criterion), computed in f32 on
    ``device``.
    """
    latents = make_paired_latents(num_of_samples, same_chunk, style_dim,
                                  torch.Generator().manual_seed(seed), z=latents)
    feats: list[list[torch.Tensor]] = []
    with torch.no_grad():
        for b, i in enumerate(range(0, num_of_samples, batch_size)):
            gen = torch.Generator(device=device).manual_seed(seed * 1_000_003 + 1 + i)
            imgs = generate_fn(latents[i : i + batch_size].to(device), gen,
                               None if noise is None else noise[b])
            fl = list(feature_fn(imgs))
            if last_layer_only:
                fl = fl[-1:]
            if not feats:
                feats = [[] for _ in fl]
            for j, f in enumerate(fl):
                feats[j].append(f.float())
        results = []
        for chunks in feats:
            layer = torch.cat(chunks, dim=0)
            d = dist_fn(layer[0::2], layer[1::2]).float().cpu().numpy()
            st = separability_stats(d)
            st["worst_pairs"] = closest_impostor_pairs(d)
            results.append(st)
    if return_latents:
        return results, latents
    return results
