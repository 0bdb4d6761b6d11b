"""Latent partitioning: the table of per-attribute latent groups.

Port of ``gan_control_tpu/latent/groups.py`` (``LatentGroup``, ``GroupSpec``
with its static arrangement tables, ``re_arrange_z``, ``same_not_same_split``,
``extract_group_latent`` and ``insert_group_latent``). The 512-d latent is
split into contiguous per-attribute sub-vectors; the split mapping network
and the controller heads address them through this table, the phase-1 G
step arranges each mini-batch so that even/odd row pairs share one group's
sub-latent, and the contrastive losses split the predictors' features by
those slots. The randomized arrangement mode and the noise arrangement are
not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

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
