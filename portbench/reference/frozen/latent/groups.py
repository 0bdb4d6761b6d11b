"""Latent partitioning: the table of per-attribute latent groups.

Port of ``gan_control_tpu/latent/groups.py`` (``LatentGroup``, ``GroupSpec``
with its static arrangement tables, ``re_arrange_z``, ``same_not_same_split``,
``extract_group_latent`` and ``insert_group_latent``). The 512-d latent is
split into contiguous per-attribute sub-vectors; the split mapping network
and the controller heads address them through this table, the phase-1 G
step arranges each mini-batch so that even/odd row pairs share one group's
sub-latent, and the contrastive losses split the predictors' features by
those slots. The ``same_for_same_id`` noise arrangement
(``re_arrange_inject_noise``) and the randomized mini-batch mode
(``random_arrangement``: a fresh slot placement per step as an
:class:`Arrangement` of arrays) are ported too.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class LatentGroup:
    """One attribute sub-space.

    latent_[start,end) — slice of the latent owned by this attribute.
    mb_[start,end) — mini-batch rows whose even/odd pairs share this
      group's sub-latent in training (None = never shared).
    count_range — (min, max) slots for the randomized arrangement mode.
    """

    name: str
    latent_start: int
    latent_end: int
    mb_start: int | None = None
    mb_end: int | None = None
    count_range: tuple[int, int] | None = None

    @property
    def latent_size(self) -> int:
        return self.latent_end - self.latent_start

    @property
    def latent_slice(self) -> slice:
        return slice(self.latent_start, self.latent_end)


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    """Ordered (by latent offset) immutable table of latent groups."""

    groups: tuple[LatentGroup, ...]
    mini_batch: int
    style_dim: int = 512

    def __post_init__(self):
        latent_total = sum(g.latent_size for g in self.groups)
        if latent_total != self.style_dim:
            raise ValueError(
                f"latent sizes sum to {latent_total}, expected {self.style_dim}"
            )
        mb_total = sum(
            g.mb_end - g.mb_start for g in self.groups if g.mb_start is not None
        )
        if mb_total and mb_total != self.mini_batch:
            raise ValueError(
                f"mini-batch slots sum to {mb_total}, expected {self.mini_batch}"
            )
        starts = [g.latent_start for g in self.groups]
        if starts != sorted(starts):
            raise ValueError("groups must be ordered by latent_start")

    @classmethod
    def from_config(
        cls, sub_groups_dict: Mapping[str, Mapping], mini_batch: int, style_dim: int = 512
    ) -> "GroupSpec":
        """Build from the JSON ``sub_groups_dict`` schema (configs/ffhq.json)."""
        groups = []
        for name, g in sub_groups_dict.items():
            pim = g.get("place_in_mini_batch")
            cnt = g.get("count_in_mini_bach") or g.get("count_in_mini_batch")
            groups.append(
                LatentGroup(
                    name=name,
                    latent_start=g["place_in_latent"][0],
                    latent_end=g["place_in_latent"][1],
                    mb_start=None if pim is None else pim[0],
                    mb_end=None if pim is None else pim[1],
                    count_range=None if cnt is None else (cnt[0], cnt[1]),
                )
            )
        groups.sort(key=lambda g: g.latent_start)
        return cls(groups=tuple(groups), mini_batch=mini_batch, style_dim=style_dim)

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(g.name for g in self.groups)

    def group(self, name: str) -> LatentGroup:
        for g in self.groups:
            if g.name == name:
                return g
        raise KeyError(name)

    def fc_dims(self) -> tuple[tuple[str, int], ...]:
        """(name, latent_size) pairs feeding the split mapping network."""
        return tuple((g.name, g.latent_size) for g in self.groups)

    def pair_source_rows(self) -> np.ndarray:
        """row -> source row for the share-copy. Odd rows inside a group's
        mini-batch slots point at the preceding even row; all others at
        themselves."""
        src = np.arange(self.mini_batch)
        for g in self.groups:
            if g.mb_start is None:
                continue
            for i in range(g.mb_start, g.mb_end - 1, 2):
                src[i + 1] = i
        return src

    def share_mask(self) -> np.ndarray:
        """[mini_batch, style_dim] bool: positions overwritten from the pair
        source row (odd row of a group pair, that group's latent columns)."""
        mask = np.zeros((self.mini_batch, self.style_dim), dtype=bool)
        for g in self.groups:
            if g.mb_start is None:
                continue
            for i in range(g.mb_start, g.mb_end - 1, 2):
                mask[i + 1, g.latent_start : g.latent_end] = True
        return mask


def re_arrange_z(spec: GroupSpec, z_list: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Arrange one mini-batch of latents so even/odd pairs inside each
    group's slot range share that group's sub-latent (copied from the even
    row to the odd one). With style mixing (two z) the second equals the
    arranged first everywhere except inside the 'other' group's slots."""
    z0 = z_list[0]
    src = torch.as_tensor(spec.pair_source_rows(), device=z0.device)
    mask = torch.as_tensor(spec.share_mask(), device=z0.device)
    z0 = torch.where(mask, z0[src], z0)
    out = [z0]
    other = next((g for g in spec.groups if g.name == "other"), None)
    for zi in z_list[1:]:
        if other is not None and other.mb_start is not None:
            rows = torch.arange(z0.shape[0], device=z0.device)
            keep_second = (rows >= other.mb_start) & (rows < other.mb_end)
            out.append(torch.where(keep_second[:, None], zi, z0))
        else:
            out.append(z0)
    return out


def re_arrange_inject_noise(
    spec: GroupSpec, noises: Sequence[torch.Tensor], group_name: str = "id"
) -> list[torch.Tensor]:
    """Copy each layer's injection noise ([B, H, W, 1]) from the even row to
    the odd row of every pair inside one group's slots (the
    ``same_for_same_id`` noise mode)."""
    g = spec.group(group_name)
    src = np.arange(spec.mini_batch)
    for i in range(g.mb_start, g.mb_end, 2):
        if i + 1 < g.mb_end:
            src[i + 1] = i
    return [n[torch.as_tensor(src, device=n.device)] for n in noises]


def same_not_same_split(
    spec: GroupSpec, features: torch.Tensor, group_name: str
) -> tuple[torch.Tensor, torch.Tensor]:
    """Split a [mini_batch, ...] tensor into the rows of one group's slots
    (same) and every other row (not_same), each in its order."""
    g = spec.group(group_name)
    same = features[g.mb_start : g.mb_end]
    not_same = torch.cat([features[: g.mb_start], features[g.mb_end :]], dim=0)
    return same, not_same


def extract_group_latent(spec: GroupSpec, latent: torch.Tensor, group_name: str) -> torch.Tensor:
    """One group's sub-latent of w ([B,512]) or w+ ([B,L,512])."""
    g = spec.group(group_name)
    return latent[..., g.latent_start : g.latent_end]


def insert_group_latent(
    spec: GroupSpec, latent: torch.Tensor, group_latent: torch.Tensor, group_name: str
) -> torch.Tensor:
    """Replace one group's sub-latent inside w ([B,512]) or w+ ([B,L,512]);
    for w+ the group value is broadcast to every layer. Returns a new
    tensor, like the JAX ``.at[].set``."""
    g = spec.group(group_name)
    if latent.ndim == 3 and group_latent.ndim == 2:
        group_latent = group_latent[:, None, :]
    out = latent.clone()
    target = out[..., g.latent_start : g.latent_end]
    target.copy_(torch.broadcast_to(group_latent.to(out.dtype), target.shape))
    return out


# ---------------------------------------------------------------------------
# The randomized mini-batch mode: a fresh placement per step, as arrays
# ---------------------------------------------------------------------------


def random_placements(spec: GroupSpec, rng: np.random.Generator) -> dict[str, list[int]]:
    """A fresh random slot placement for every group, as {group: sorted even
    slot starts}; a start s places the arranged pair (s, s + 1). Draw for
    draw as the JAX function: a group with a ``count_range`` draws an even
    size from ``arange(lo, hi + 2, 2)``, then ``size // 2`` even starts
    without replacement, independently of the other groups (placements may
    overlap and need not cover the mini-batch); a group without one keeps
    its static placement."""
    placements: dict[str, list[int]] = {}
    even_slots = np.arange(0, spec.mini_batch, 2)
    for g in spec.groups:
        if g.count_range is None:
            placements[g.name] = (list(range(g.mb_start, g.mb_end, 2))
                                  if g.mb_start is not None else [])
            continue
        lo, hi = g.count_range
        size = int(rng.choice(np.arange(lo, hi + 2, 2)))
        starts: list[int] = []
        if size > 0:
            starts = sorted(int(v) for v in rng.choice(even_slots, size // 2, replace=False))
        placements[g.name] = starts
    return placements


@dataclasses.dataclass
class Arrangement:
    """One mini-batch arrangement as arrays (numpy on the host, or tensors
    after :meth:`to`); the step applies it to every mini-batch chunk.

    pair_src: [mini_batch] int — row -> source row of the share-copy.
    share_mask: [mini_batch, style_dim] bool — latent positions copied from
      ``pair_src`` (each pair's odd row, its group's latent columns).
    noise_pair_src: [mini_batch] int — the pairing of the noise group
      ('id') only, for ``same_for_same_id`` noise.
    same_pair_masks: {group: [mini_batch, mini_batch] bool} — entry
      [odd, even] of each of the group's pairs.
    not_same_pair_masks: {group: [mini_batch, mini_batch] bool} — the rows
      outside every pair of the group, in batch order, paired by adjacency,
      entry [later, earlier].
    """

    pair_src: Any
    share_mask: Any
    noise_pair_src: Any
    same_pair_masks: dict
    not_same_pair_masks: dict

    def to(self, device: torch.device | str) -> "Arrangement":
        """The same arrangement as tensors on ``device``."""
        t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        return Arrangement(
            pair_src=t(self.pair_src), share_mask=t(self.share_mask),
            noise_pair_src=t(self.noise_pair_src),
            same_pair_masks={k: t(v) for k, v in self.same_pair_masks.items()},
            not_same_pair_masks={k: t(v) for k, v in self.not_same_pair_masks.items()},
        )


def arrangement_from_placements(spec: GroupSpec, placements: Mapping[str, Sequence[int]],
                                noise_group: str = "id") -> Arrangement:
    """{group: even slot starts} as an :class:`Arrangement` of numpy arrays."""
    n = spec.mini_batch
    pair_src = np.arange(n, dtype=np.int32)
    share = np.zeros((n, spec.style_dim), dtype=bool)
    noise_src = np.arange(n, dtype=np.int32)
    same_masks, not_same_masks = {}, {}
    for g in spec.groups:
        m = np.zeros((n, n), dtype=bool)
        in_group = np.zeros((n,), dtype=bool)
        for s0 in placements.get(g.name, []):
            m[s0 + 1, s0] = True
            in_group[s0] = in_group[s0 + 1] = True
            pair_src[s0 + 1] = s0
            share[s0 + 1, g.latent_start : g.latent_end] = True
            if g.name == noise_group:
                noise_src[s0 + 1] = s0
        same_masks[g.name] = m
        comp = np.flatnonzero(~in_group)
        nm = np.zeros((n, n), dtype=bool)
        for a, b in zip(comp[0::2], comp[1::2]):
            nm[max(a, b), min(a, b)] = True
        not_same_masks[g.name] = nm
    return Arrangement(pair_src=pair_src, share_mask=share, noise_pair_src=noise_src,
                       same_pair_masks=same_masks, not_same_pair_masks=not_same_masks)


def arrangement_from_spec(spec: GroupSpec, noise_group: str = "id") -> Arrangement:
    """The static spec's placement as an :class:`Arrangement`."""
    placements = {g.name: (list(range(g.mb_start, g.mb_end, 2)) if g.mb_start is not None else [])
                  for g in spec.groups}
    return arrangement_from_placements(spec, placements, noise_group=noise_group)


def random_arrangement(spec: GroupSpec, rng: np.random.Generator,
                       noise_group: str = "id") -> Arrangement:
    """A fresh random placement for one step (see :func:`random_placements`)."""
    return arrangement_from_placements(spec, random_placements(spec, rng), noise_group=noise_group)


def apply_arrangement_z(arr: Arrangement, z: torch.Tensor) -> torch.Tensor:
    """``re_arrange_z`` by the arrangement's tables, for one z (the
    randomized mode has no style mixing)."""
    src = torch.as_tensor(arr.pair_src, device=z.device).long()
    mask = torch.as_tensor(arr.share_mask, device=z.device)
    return torch.where(mask, z[src], z)


def apply_arrangement_noise(arr: Arrangement, noises: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """``re_arrange_inject_noise`` by the arrangement's tables."""
    return [n[torch.as_tensor(arr.noise_pair_src, device=n.device).long()] for n in noises]
