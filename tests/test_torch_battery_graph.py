"""When the battery's CUDA graph engages (``losses/battery_graph.py``), on
the CPU: the predicate, one condition at a time, on stand-in CUDA images;
every CPU call of ``_attr_losses_for_batch`` eager and counted as such
(plain, int8 storage, remat, an arrangement, data parallelism), with the
eager body's numbers; a recast battery changing the graph's key;
``battery_graph.reset`` dropping every graph; and ``normalize_channels``'
cached constants. The card's side:
``tests/test_torch_battery_graph_gpu.py``."""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch
from torch import nn

from gan_control_torch.latent.groups import GroupSpec, LatentGroup, random_arrangement
from gan_control_torch.losses import battery_graph
from gan_control_torch.losses.contrastive import ContrastiveConfig, pairwise_l1
from gan_control_torch.losses.predictors import common
from gan_control_torch.losses.registry import cast_predictor_params
from gan_control_torch.training import train_step as ts
from gan_control_torch.utils import collectives, tracing

BATCH = 8
SPEC = GroupSpec(groups=(LatentGroup("id", 0, 4, mb_start=0, mb_end=4, count_range=(2, 6)),
                         LatentGroup("other", 4, 8, mb_start=4, mb_end=8, count_range=(2, 6))),
                 mini_batch=BATCH, style_dim=8)
CFG = ContrastiveConfig(intermediate_weights=(0.5,), last_layer_weight=1.0, lower_thres=(0.05,),
                        upper_thres=(0.5,), last_lower_thres=0.05, last_upper_thres=0.5,
                        focus_on=("same_as_last_layer", "same_as_last_layer"))


class _Net(nn.Module):
    """Two layers of features of NHWC images: a conv's map and its mean."""

    def __init__(self, seed: int):
        super().__init__()
        self.conv = nn.Conv2d(3, 4, 3, padding=1)
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            self.conv.weight.copy_(torch.randn(self.conv.weight.shape, generator=gen) * 0.3)
            self.conv.bias.zero_()
        self.register_buffer("shift", torch.full((4,), 0.1))

    def forward(self, images):
        x = torch.relu(self.conv(common.to_nchw(images).to(self.conv.weight.dtype)))
        return [common.to_nhwc(x), x.mean(dim=(2, 3)) + self.shift.to(x.dtype)]


def _battery():
    net = _Net(0)
    net.eval().requires_grad_(False)
    specs = tuple(ts.AttributeLossSpec(name=name, group=group, cfg=CFG,
                                       feature_fn=lambda m, x: m(x), dist_fn=pairwise_l1)
                  for name, group in (("a_loss", "id"), ("b_loss", "other")))
    return specs, {"a_loss": net, "b_loss": net}


def _images(seed=1):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn((BATCH, 8, 8, 3), generator=gen) * 0.5).requires_grad_(True)


@pytest.fixture(autouse=True)
def _empty_store():
    tracing.reset()
    yield
    tracing.reset()


def _stand_in(**kw):
    """What ``engages`` reads of the images, as on the card."""
    return types.SimpleNamespace(**{"is_cuda": True, "requires_grad": True, **kw})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_engages_on_cuda_for_each_float_storage(dtype):
    assert battery_graph.engages(_stand_in(), dtype, remat=False, arrangement=None)


@pytest.mark.parametrize("why", ["cpu", "int8", "remat", "arrangement", "sharded", "no_grad",
                                 "images_take_no_gradient"])
def test_does_not_engage(why, monkeypatch):
    images, dtype, remat, arrangement = _stand_in(), torch.bfloat16, False, None
    if why == "cpu":
        images = _stand_in(is_cuda=False)
    elif why == "int8":
        dtype = torch.int8
    elif why == "remat":
        remat = True
    elif why == "arrangement":
        arrangement = random_arrangement(SPEC, np.random.default_rng(0))
    elif why == "sharded":
        monkeypatch.setattr(collectives, "sharded", lambda: True)
    elif why == "images_take_no_gradient":
        images = _stand_in(requires_grad=False)
    with torch.no_grad() if why == "no_grad" else torch.enable_grad():
        assert not battery_graph.engages(images, dtype, remat, arrangement)


@pytest.mark.parametrize("mode", ["plain", "int8", "remat", "arrangement", "sharded"])
def test_cpu_calls_run_eagerly_and_are_counted(mode, monkeypatch):
    specs, predictors = _battery()
    images = _images()
    dtype, remat, arrangement = torch.float32, False, None
    if mode == "int8":
        dtype = torch.int8
    elif mode == "remat":
        remat = True
    elif mode == "arrangement":
        arrangement = random_arrangement(SPEC, np.random.default_rng(0)).to("cpu")
    elif mode == "sharded":
        # one process standing in for a rank: the gathers return its rows
        monkeypatch.setattr(collectives, "sharded", lambda: True)
        monkeypatch.setattr(collectives, "gather_batch", lambda x: x)
    stored = cast_predictor_params(dict(predictors), "int8") if mode == "int8" else predictors
    # the eager body's numbers: under int8 on the nets dequantised to bf16
    nets = stored.nets(torch.bfloat16) if mode == "int8" else predictors
    compute = torch.bfloat16 if mode == "int8" else torch.float32
    want, want_m = ts._battery_losses(specs, SPEC, nets, images.to(compute), 1, False,
                                      arrangement, ts.contrastive_loss)
    (want_g,) = torch.autograd.grad(want, images)
    calls = 3
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(calls):
            total, metrics = ts._attr_losses_for_batch(specs, SPEC, stored, images, 1, remat=remat,
                                                       dtype=dtype, arrangement=arrangement)
    counts = {k: v["count"] for k, v in tracing.summary().items() if k.startswith("battery_")}
    assert counts == {"battery_eager": calls}
    assert specs[0] not in battery_graph._GRAPHS
    assert set(metrics) == set(want_m) == {"g_a_loss", "g_b_loss"}
    assert total.requires_grad and all(m.requires_grad for m in metrics.values())
    (grad,) = torch.autograd.grad(total, images)
    assert torch.equal(total, want) and torch.equal(grad, want_g)
    assert all(torch.equal(metrics[k], want_m[k]) for k in want_m)


def test_a_recast_battery_changes_the_key():
    """The key holds each parameter's and buffer's address and dtype: the
    same battery reads the same key, a recast one another."""
    _, predictors = _battery()
    g = battery_graph.GraphedBattery()
    first = g._storage(predictors.values())
    assert g._storage(predictors.values()) == first
    assert len(first) == 3  # weight, bias, shift: the shared net once
    cast_predictor_params(predictors, "float16")
    recast = g._storage(predictors.values())
    assert recast != first and {d for _, d in recast} == {torch.float16}
    predictors["a_loss"].shift = torch.zeros(4, dtype=torch.float16)  # a buffer replaced
    assert g._storage(predictors.values()) != recast


def test_reset_drops_every_graph():
    specs, _ = _battery()
    g = battery_graph._GRAPHS[specs[0]] = battery_graph.GraphedBattery()
    g.key, g.warm = ("a key",), True
    battery_graph.reset()
    assert specs[0] not in battery_graph._GRAPHS and len(battery_graph._GRAPHS) == 0
    assert not g.warm


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_std", [False, True])
def test_normalize_channels_reads_one_cached_constant(dtype, with_std):
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32) if with_std else None
    x = torch.randn((2, 3, 5, 5), generator=torch.Generator().manual_seed(0)).to(dtype)
    got = common.normalize_channels(x, mean, std)
    # the expression it replaced: the constants uploaded at every call
    wide = torch.promote_types(dtype, torch.float32)

    def const(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=x.device).to(wide).view(1, -1, 1, 1)

    want = x.to(wide) - const(mean)
    want = want if std is None else want / const(std)
    assert got.dtype == wide and torch.equal(got, want)
    key = (tuple(mean.tolist()), x.device, wide)
    assert common._channel_const(*key) is common._channel_const(*key)
    assert torch.equal(common._channel_const(*key), const(mean))
