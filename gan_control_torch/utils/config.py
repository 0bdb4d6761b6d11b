"""JSON config system.

Keeps the EXACT schema of the reference configs (configs/ffhq.json etc. —
sections model_config / training_config / data_config / evaluation_config /
tensorboard_config / monitor_config / ckpt_config) so shipped configs work
unchanged, plus the same experiment-directory contract: the resolved config
is re-exported as ``args.json`` into a timestamped save dir and that file is
the model metadata consumed by inference (reference utils/file_utils.py:28-61,
inference/inference.py:110-119).

Reference behaviors reproduced:
  - attribute access wrapper (``DefaultObj``-like, file_utils.py:9-19)
  - experiment-name mangling from enabled loss weights
    (generator_trainer.py:867-903 ``add_weight_to_name``)
  - timestamped save dir + args.json export (file_utils.py:28-61)
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Mapping


class ConfigObj:
    """Attribute + item access over nested dicts. Missing keys RAISE
    AttributeError like the reference's DefaultObj (file_utils.py:9-19,
    which sets __dict__ = dict) — returning None would silently mask
    config typos flowing into arithmetic/conditionals."""

    def __init__(self, d: Mapping[str, Any]):
        self._d = dict(d)

    def __getattr__(self, key):
        if key.startswith("_"):
            raise AttributeError(key)
        if key not in self._d:
            raise AttributeError(
                f"config has no key {key!r} (have {sorted(self._d)[:12]}...)"
            )
        v = self._d[key]
        return ConfigObj(v) if isinstance(v, dict) else v

    def __getitem__(self, key):
        return self._d[key]

    def __contains__(self, key):
        return key in self._d

    def get(self, key, default=None):
        return self._d.get(key, default)

    def keys(self):
        return self._d.keys()

    def items(self):
        return self._d.items()

    def to_dict(self) -> dict:
        return self._d


def read_json(path: str | Path, return_obj: bool = False):
    with open(path) as f:
        d = json.load(f)
    return ConfigObj(d) if return_obj else d


def write_json(d: Mapping[str, Any], path: str | Path):
    with open(path, "w") as f:
        json.dump(d, f, indent=2)




def add_weight_to_name(save_name: str, training_config: Mapping[str, Any]) -> str:
    """Reference-exact run-name mangling (generator_trainer.py:867-903):
    sorted ``*_loss`` keys (recon_3d expanding its sorted sub-losses),
    fragment = same_group_name[:3] + dot-stripped last_layer_weight
    (0.5 -> '05', 2 -> '2', 1.5 --> '15'), fragments concatenated with NO
    separator, then '_' + save_name appended at the END — so run dirs
    match reference-produced names."""

    def weight_str(w) -> str:
        if w < 1:
            return "0" + str(w).split(".")[-1]
        if int(w) == w:
            return "%d" % int(w)
        a, b = str(w).split(".")
        return a + b

    def fragment(blk: Mapping[str, Any]) -> str:
        return blk["same_group_name"][:3] + weight_str(blk["last_layer_weight"])

    name = ""
    for key in sorted(training_config):
        if key.split("_")[-1] != "loss":
            continue
        blk = training_config[key]
        if not isinstance(blk, dict) or not blk.get("enabled"):
            continue
        if key == "recon_3d_loss":
            for key3d in sorted(blk):
                if key3d.split("_")[-1] != "loss":
                    continue
                sb = blk[key3d]
                if isinstance(sb, dict) and sb.get("enabled"):
                    name += fragment(sb)
        else:
            name += fragment(blk)
    if save_name:
        name = name + "_" + save_name
    return name


def make_save_dir(
    results_dir: str | Path,
    save_name: str,
    config: Mapping[str, Any],
    debug: bool = False,
    timestamp: bool = True,
) -> Path:
    """Create ``results_dir/<save_name>[_debug][_YYmmdd_HHMMSS]`` with the
    reference layout (checkpoint/, images/, graphs/, buckets/) and export
    the resolved config as args.json."""
    name = save_name + ("_debug" if debug else "")
    if timestamp:
        name = name + time.strftime("_%y%m%d_%H%M%S")
    save_dir = Path(results_dir) / name
    for sub in ("checkpoint", "images", "graphs", "buckets"):
        (save_dir / sub).mkdir(parents=True, exist_ok=True)
    write_json(dict(config), save_dir / "args.json")
    return save_dir


def config_checks(config: Mapping[str, Any]) -> list[str]:
    """Config consistency validation (the reference admits
    `TODO: implement config checks`, generator_trainer.py:96-106 — here they
    are actually implemented). Returns a list of problems; empty = OK."""
    problems = []
    mc, tc = config.get("model_config", {}), config.get("training_config", {})
    if mc.get("split_fc") and mc.get("marge_fc"):
        problems.append("split_fc and marge_fc are mutually exclusive")
    if tc.get("batch", 0) % max(tc.get("mini_batch", 1), 1):
        problems.append("batch must be a multiple of mini_batch")
    if tc.get("augment", {}).get("enabled") and tc.get("mini_batch") != tc.get("batch"):
        problems.append("ADA augment requires mini_batch == batch")
    if not mc.get("vanilla", False):
        sgd = tc.get("sub_groups_dict", {})
        latent_total = sum(
            g["place_in_latent"][1] - g["place_in_latent"][0] for g in sgd.values()
        )
        if latent_total != mc.get("latent_size", 512):
            problems.append(
                f"sub_groups_dict latent sizes sum to {latent_total}, "
                f"expected {mc.get('latent_size', 512)}"
            )
        mb_total = sum(
            g["place_in_mini_batch"][1] - g["place_in_mini_batch"][0]
            for g in sgd.values()
            if g.get("place_in_mini_batch") is not None
        )
        if tc.get("mini_batch_mode", "normal") == "normal" and mb_total != tc.get("mini_batch"):
            problems.append(
                f"sub_groups_dict mini-batch slots sum to {mb_total}, "
                f"expected mini_batch={tc.get('mini_batch')}"
            )
        if tc.get("mini_batch_mode") == "random" and tc.get("mini_batch") != tc.get("batch"):
            problems.append("random mini_batch_mode requires mini_batch == batch")
    size = mc.get("size", 512)
    if size not in (256, 512, 896, 1024) and (size & (size - 1)):
        problems.append(f"size {size} is not a power of 2 (or 896)")
    return problems
