"""The cells at a tiny size on the CPU, for the tests: G and D at 32 px and
32 channels, the battery cut to the nets a test names."""

from __future__ import annotations

import torch

from portbench import harness

SEED = 2**31 + 11
torch.set_num_threads(min(4, torch.get_num_threads()))


def tiny_config(name: str, losses=(), f32: bool = False) -> dict:
    config = harness.config(name)
    config["model_config"].update(size=32, max_channels=32)
    tc = config["training_config"]
    for k, v in tc.items():
        if isinstance(v, dict) and "enabled" in v and k != "augment" and k not in losses:
            v["enabled"] = False
    if f32:
        config["model_config"]["mixed_precision"] = False
        tc["predictor_dtype"] = "float32"
    return config


def tiny_serve(seconds: float = 2.0, fault=None, control=False, trace=False, f32=False) -> dict:
    cell = harness.workload("ffhq512-serve")
    tr = cell["traffic"]
    tr["sizes"] = dict(tr["sizes"], high=8, block=16)
    tr.update(buckets=[1, 4, 8], check_rate=0.5, trace_seconds=seconds / 2)
    return harness.driver("serve").run(cell, tiny_config("ffhq512", f32=f32), SEED, seconds, trace,
                                       torch.device("cpu"), fault=fault, control=control)


def tiny_train(cell_name: str = "ffhq512-train", losses=(), fault=None, control=False,
               trace=False, f32=False) -> dict:
    cell = harness.workload(cell_name)
    config = tiny_config(cell["config"], losses, f32)
    return harness.driver("train").run(cell, config, SEED, 0.5, trace, torch.device("cpu"),
                                       fault=fault, control=control)
