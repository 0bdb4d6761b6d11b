"""The battery's CUDA graph on the card (``gpu`` marker; skip without one),
against the eager battery (``losses/battery_graph.py``).

This file imports neither JAX nor the JAX package; on a machine with a card
run it with

    python -m pytest --noconftest -m gpu tests/test_torch_battery_graph_gpu.py -q

The FFHQ battery (six nets) at random weights, its statistics set from
smooth 512-px images (``calibrate_battery``), stored in bf16 as the
published config stores it, at batch 16 (one mini-batch chunk). Three
calls of ``_attr_losses_for_batch`` on different images (the first eager,
the second captures and replays, the third replays) against the eager body
on the same images: the total and each loss to ``VALUE_RTOL``, the image
gradient to ``GRAD_REL_L2`` in relative L2 norm (``chip_smoke.py``'s bf16
gradient bound). A call's metrics and gradient survive the next replay. A
battery recast to float16 after capture runs eagerly again and is captured
again, on its new weights; weights changed in place are read by the next
replay. A criterion patched in after capture runs eagerly (it is part of
the key), and after ``battery_graph.reset()`` the next call is eager.
"""

import json
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from gan_control_torch.losses import battery_graph
from gan_control_torch.losses.registry import build_attr_losses, calibrate_battery, cast_predictor_params
from gan_control_torch.models.factory import build_group_spec
from gan_control_torch.training import train_step as ts

FFHQ = json.loads((Path(__file__).resolve().parent.parent / "gan_control_tpu" / "configs"
                   / "ffhq.json").read_text())
BATCH = 16
VALUE_RTOL = 1e-3
GRAD_REL_L2 = 2.0 ** -6


def _images(seed: int, n: int, dtype: torch.dtype) -> torch.Tensor:
    """Smooth NHWC images in about [-1, 1] on the card, taking a gradient."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    small = torch.randn((n, 3, 32, 32), generator=gen, device="cuda") * 0.5
    big = F.interpolate(small, size=(512, 512), mode="bilinear", align_corners=False)
    return big.permute(0, 2, 3, 1).contiguous().to(dtype).requires_grad_(True)


@pytest.fixture(scope="module")
def battery():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs run only on the card")
    specs, predictors = build_attr_losses(FFHQ["training_config"], device="cuda", seed=3)
    with torch.no_grad():
        calibrate_battery(predictors, _images(0, 4, torch.float32).detach())
    cast_predictor_params(predictors, "bfloat16")
    return specs, predictors, build_group_spec(FFHQ)


@pytest.fixture
def fresh(battery):
    """The battery with no graph yet, stored in bf16."""
    specs, predictors, spec = battery
    battery_graph._GRAPHS.pop(specs[0], None)
    cast_predictor_params(predictors, "bfloat16")
    yield battery
    battery_graph._GRAPHS.pop(specs[0], None)


def _call(battery, images, dtype):
    specs, predictors, spec = battery
    return ts._attr_losses_for_batch(specs, spec, predictors, images, 1, dtype=dtype)


def _eager(battery, images):
    specs, predictors, spec = battery
    total, metrics = ts._battery_losses(specs, spec, predictors, images, 1, False, None,
                                        ts.contrastive_loss)
    (grad,) = torch.autograd.grad(total, images)
    return total.detach(), {k: v.detach() for k, v in metrics.items()}, grad


def _graph(battery):
    return battery_graph._GRAPHS[battery[0][0]]


def _assert_matches(battery, out, images, grad=None):
    total, metrics = out
    if grad is None:
        (grad,) = torch.autograd.grad(total, images)
    want_t, want_m, want_g = _eager(battery, images)
    assert set(metrics) == set(want_m)
    for k, got in [("total", total)] + [(k, metrics[k]) for k in want_m]:
        got = got.detach()
        want = want_t if k == "total" else want_m[k]
        assert torch.isfinite(want), k
        assert abs(float(got) - float(want)) <= VALUE_RTOL * abs(float(want)), (k, float(got), float(want))
    rel = float((grad.float() - want_g.float()).norm() / want_g.float().norm())
    assert rel <= GRAD_REL_L2, rel
    return rel


@pytest.mark.gpu
def test_three_calls_match_the_eager_battery(fresh):
    images = [_images(10 + i, BATCH, torch.bfloat16) for i in range(3)]
    outs, held = [], None
    for i, x in enumerate(images):
        outs.append(_call(fresh, x, torch.bfloat16))
        assert (_graph(fresh).graph is not None) == (i >= 1)
        if i == 1:
            held = {k: v.clone() for k, v in outs[1][1].items()}
    # the second call's metrics, and its gradient, outlive the third replay
    assert all(torch.equal(outs[1][1][k], v) for k, v in held.items())
    assert not any(v.requires_grad for v in outs[2][1].values())
    rels = [_assert_matches(fresh, out, x) for out, x in zip(outs, images)]
    print(f"image gradient relative L2 to the eager battery, calls 1-3: {rels}")


@pytest.mark.gpu
def test_a_recast_battery_is_captured_again(fresh):
    for i in range(3):
        _call(fresh, _images(20 + i, BATCH, torch.bfloat16), torch.bfloat16)
    captured = _graph(fresh).graph
    assert captured is not None
    cast_predictor_params(fresh[1], "float16")
    for i in range(3):
        x = _images(30 + i, BATCH, torch.float16)
        out = _call(fresh, x, torch.float16)
        g = _graph(fresh)
        assert (g.graph is not None) == (i >= 1) and g.graph is not captured
        _assert_matches(fresh, out, x)


@pytest.mark.gpu
def test_weights_changed_in_place_are_read_by_the_replay(fresh):
    for i in range(2):
        _call(fresh, _images(40 + i, BATCH, torch.bfloat16), torch.bfloat16)
    captured = _graph(fresh).graph
    x = _images(42, BATCH, torch.bfloat16)
    before = _call(fresh, x, torch.bfloat16)[1]
    # the R-Net's first conv, ahead of a batch norm of fixed statistics
    weight = fresh[1]["recon_3d_loss"].conv1.weight
    saved = weight.detach().clone()
    try:
        with torch.no_grad():
            weight.mul_(1.5)
        out = _call(fresh, x, torch.bfloat16)
        assert _graph(fresh).graph is captured
        assert any(not torch.equal(before[k], out[1][k]) for k in before)
        _assert_matches(fresh, out, x)
    finally:
        with torch.no_grad():
            weight.copy_(saved)


@pytest.mark.gpu
def test_a_patched_criterion_and_a_reset_run_eagerly(fresh, monkeypatch):
    for i in range(3):
        _call(fresh, _images(50 + i, BATCH, torch.bfloat16), torch.bfloat16)
    assert _graph(fresh).graph is not None
    x = _images(53, BATCH, torch.bfloat16)
    replayed = float(_call(fresh, x, torch.bfloat16)[0].detach())
    orig = ts.contrastive_loss
    monkeypatch.setattr(ts, "contrastive_loss", lambda *args: 2 * orig(*args))
    doubled = float(_call(fresh, x, torch.bfloat16)[0].detach())
    assert _graph(fresh).graph is None
    assert abs(doubled - 2 * replayed) <= VALUE_RTOL * abs(2 * replayed), (doubled, replayed)
    monkeypatch.setattr(ts, "contrastive_loss", orig)
    for i in range(2):
        _call(fresh, _images(54 + i, BATCH, torch.bfloat16), torch.bfloat16)
    assert _graph(fresh).graph is not None
    battery_graph.reset()
    assert fresh[0][0] not in battery_graph._GRAPHS
    _call(fresh, x, torch.bfloat16)
    assert _graph(fresh).graph is None
