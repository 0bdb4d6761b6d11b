"""Phase-2 attribute tables -> (controls, w-latents) batches (port of
``gan_control_tpu/data/dataframe.py``).

The phase-2a sweep writes one row per generated image: ``latents`` (z),
``latents_w`` (w) and one column per predictor output (``age``,
``orientation``, ``expression_q``, ``hair``, ``gamma3d``,
``expression3d``, ``orientation3d``, ``arcface_emb``). The controller
trainer reads one attribute column and ``latents_w``; the first 90 % of the
rows train and the last 10 % evaluate, by row order; ``expression_q`` comes
back one-hot.

Table format, chosen by the path's suffix, never silently:

  - ``.npz`` (numpy only): one array per column name, rows in order; a
    vector column is ``[N, D]``, a scalar column ``[N]`` float64 (the
    Python float the JAX sweep stores per row).
  - ``.pkl``: the JAX package's pandas DataFrame pickle, read and written
    as the JAX package does (a vector column holds one array per row, a
    scalar column a float). It needs pandas; without it a ``.pkl`` path
    raises ``ImportError`` naming the ``.npz`` route.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Iterator, Mapping

import numpy as np

ATTRIBUTE_COLUMNS = {
    "age_loss": "age",
    "orientation_loss": "orientation",
    "hair_loss": "hair",
    "gamma_loss": "gamma3d",
    "recon_gamma_loss": "gamma3d",
    # expression picks its column by the controller's in_dim: 64 ->
    # expression3d, 8 -> expression_q
    "expression_loss_64": "expression3d",
    "expression_loss_8": "expression_q",
}

NUM_EXPRESSION_CLASSES = 8


def attribute_column_for(loss_name: str, in_dim: int | None = None) -> str:
    """The table column a controller of ``loss_name`` learns from."""
    if loss_name == "expression_loss":
        if in_dim is not None and in_dim not in (64, 8):
            raise ValueError(
                f"expression_loss in_dim must be 8 (expression_q) or 64 "
                f"(expression3d), got {in_dim}"
            )
        return "expression3d" if (in_dim or 64) == 64 else "expression_q"
    if loss_name in ATTRIBUTE_COLUMNS:
        return ATTRIBUTE_COLUMNS[loss_name]
    raise ValueError(f"no attribute column mapping for {loss_name}")


def _pandas(path: Path):
    try:
        import pandas as pd
    except ImportError as e:
        raise ImportError(
            f"{path}: a .pkl attribute table is a pandas DataFrame and pandas is not "
            "installed; write and read the table as .npz (numpy only) instead"
        ) from e
    return pd


def _is_pickle(path: Path) -> bool:
    if path.suffix == ".pkl":
        return True
    if path.suffix == ".npz":
        return False
    raise ValueError(f"{path}: an attribute table is a .npz or a .pkl file")


def read_table(path: str | Path) -> dict[str, np.ndarray]:
    """Column name -> array of every row, in row order (see the module
    docstring for the two formats)."""
    path = Path(path)
    if _is_pickle(path):
        df = _pandas(path).read_pickle(path)
        out = {}
        for name in df.columns:
            values = list(df[name])
            if values and np.ndim(values[0]) == 0:
                out[name] = np.asarray(values, np.float64)
            else:
                out[name] = np.stack([np.asarray(v) for v in values])
        return out
    with np.load(path, allow_pickle=False) as f:
        return {name: f[name] for name in f.files}


def write_table(path: str | Path, columns: Mapping[str, np.ndarray]) -> None:
    """Write ``columns`` (name -> ``[N, ...]`` array, one row per image) to
    ``path``: a vector column row by row, a scalar column as floats. The file
    is replaced atomically."""
    path = Path(path)
    pickle = _is_pickle(path)
    columns = {k: np.asarray(v) for k, v in columns.items()}
    n = {len(v) for v in columns.values()}
    if len(n) > 1:
        raise ValueError(f"columns of different lengths: { {k: len(v) for k, v in columns.items()} }")
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    if pickle:
        pd = _pandas(path)
        rows = n.pop() if n else 0
        df = pd.DataFrame([
            {name: (arr[i] if arr.ndim > 1 else float(arr[i])) for name, arr in columns.items()}
            for i in range(rows)
        ])
        df.to_pickle(tmp, compression=None)
    else:
        scalars = {k: (v.astype(np.float64) if v.ndim == 1 else v) for k, v in columns.items()}
        with open(tmp, "wb") as f:
            np.savez(f, **scalars)
    os.replace(tmp, path)


def _split(table: Mapping[str, np.ndarray], train: bool, eval_fraction: float) -> slice:
    n = len(table["latents_w"])
    split = int(n * (1 - eval_fraction))
    return slice(0, split) if train else slice(split, n)


def _controls(values: np.ndarray, attribute: str) -> np.ndarray:
    controls = np.asarray(values, np.float32).reshape(len(values), -1)
    if attribute == "expression_q":
        onehot = np.zeros((len(controls), NUM_EXPRESSION_CLASSES), np.float32)
        onehot[np.arange(len(controls)), controls.astype(int).ravel()] = 1.0
        controls = onehot
    return controls


class DataFrameDataset:
    """(controls ``[N, D]``, latents_w ``[N, 512]``) of one attribute
    column, as float32 numpy arrays."""

    def __init__(self, df_path: str | Path, attribute: str, train: bool = True,
                 eval_fraction: float = 0.1):
        table = read_table(df_path)
        rows = _split(table, train, eval_fraction)
        self.controls = _controls(table[attribute][rows], attribute)
        self.latents_w = np.asarray(table["latents_w"][rows], np.float32).reshape(len(self.controls), -1)

    def __len__(self):
        return len(self.controls)

    def __getitem__(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        return self.controls[i], self.latents_w[i]


class MergedDataFrameDataset:
    """Every listed attribute column at once: (controls dict, latents_w) per
    row, for a merged controller over a vanilla generator."""

    def __init__(self, df_path: str | Path, attributes: list[str],
                 train: bool = True, eval_fraction: float = 0.1):
        table = read_table(df_path)
        rows = _split(table, train, eval_fraction)
        self.controls = {attr: _controls(table[attr][rows], attr) for attr in attributes}
        w = table["latents_w"][rows]
        self.latents_w = np.asarray(w, np.float32).reshape(len(w), -1)

    def __len__(self):
        return len(self.latents_w)


def _batch_size(batch_size: int, n: int, df_path, train: bool) -> int:
    # never exceed the split: a 50-row eval batch over a 20-row split would
    # otherwise give an empty epoch and spin forever
    bs = min(batch_size, n)
    if bs < 1:
        raise ValueError(f"empty attribute-table split (train={train}) in {df_path}")
    return bs


def get_dataframe_data_loader(
    df_path: str | Path,
    attribute: str,
    batch_size: int,
    train: bool = True,
    seed: int = 0,
) -> tuple[Iterator[tuple[np.ndarray, np.ndarray]], DataFrameDataset]:
    """Infinite shuffled (controls, w) batches and the dataset: each epoch
    is ``np.random.default_rng(seed).permutation`` cut into whole batches,
    the JAX loader's batches for the same seed."""
    ds = DataFrameDataset(df_path, attribute, train=train)
    rng = np.random.default_rng(seed)
    bs = _batch_size(batch_size, len(ds), df_path, train)

    def gen():
        while True:
            perm = rng.permutation(len(ds))
            for s in range(0, len(perm) - bs + 1, bs):
                idx = perm[s : s + bs]
                yield ds.controls[idx], ds.latents_w[idx]

    return gen(), ds


def get_merged_dataframe_data_loader(
    df_path: str | Path,
    attributes: list[str],
    batch_size: int,
    train: bool = True,
    seed: int = 0,
) -> tuple[Iterator[tuple[dict, np.ndarray]], MergedDataFrameDataset]:
    """Infinite shuffled ({attribute: controls}, w) batches, drawn as
    :func:`get_dataframe_data_loader` draws them."""
    ds = MergedDataFrameDataset(df_path, attributes, train=train)
    rng = np.random.default_rng(seed)
    bs = _batch_size(batch_size, len(ds), df_path, train)

    def gen():
        while True:
            perm = rng.permutation(len(ds))
            for s in range(0, len(perm) - bs + 1, bs):
                idx = perm[s : s + bs]
                yield {a: v[idx] for a, v in ds.controls.items()}, ds.latents_w[idx]

    return gen(), ds
