"""The frozen predictor battery on the card against the CPU (``gpu`` marker;
skip without one).

This file imports neither JAX nor the JAX package; on a machine with a card
run it with

    python -m pytest --noconftest tests/test_torch_predictors_gpu.py -q

Each of the six nets of the FFHQ battery, and the three that the AFHQ and
MetFaces configs add (DogFaceNet, ResNet-18, the VGG-16 style net), runs at
batch 2, f32 with TF32 off, on smooth 512-px images, from the same weights
on both devices (the batch-norm statistics set from those images, and the
hair mask centred, by ``losses.registry.calibrate_battery``). The
comparison is ``chip_smoke``'s: every returned layer to 1e-3 of its largest
entry, the image gradient of a seeded projection to 5e-2 in relative L2
norm, a hair mask pixel flipped only at the threshold (logits within 1e-2
of max). ADA's ``apply_affine`` and ``apply_color`` on the card against the
CPU, as ``chip_smoke`` holds them.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

from gan_control_torch.losses.registry import (  # noqa: E402
    build_attr_losses,
    calibrate_battery,
    distinct_predictors,
)

FFHQ = json.loads((REPO / "gan_control_tpu" / "configs" / "ffhq.json").read_text())
NETS = ("embedding_loss", "orientation_loss", "age_loss", "expression_loss", "hair_loss", "recon_3d_loss")
NEW_NETS = tuple(chip_smoke.NEW_NETS)


@pytest.fixture(scope="module")
def battery():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    small = np.random.default_rng(0).standard_normal((4, 3, 32, 32)).astype(np.float32) * 0.5
    images = F.interpolate(torch.from_numpy(small), size=(512, 512), mode="bilinear",
                           align_corners=False).permute(0, 2, 3, 1).contiguous()
    _, predictors = build_attr_losses(FFHQ["training_config"], device="cpu", seed=3)
    calibrate_battery(predictors, images)
    yield distinct_predictors(predictors), images
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


@pytest.mark.gpu
@pytest.mark.parametrize("name", NETS)
def test_predictor_card_matches_cpu(battery, name):
    nets, images = battery
    errs = chip_smoke.predictor_card_vs_cpu(name, nets[name], images[:2], seed=NETS.index(name))
    assert errs["layers"] <= chip_smoke.PREDICTOR_RTOL
    assert errs["grad_rel_l2"] <= chip_smoke.PREDICTOR_GRAD_REL_L2


@pytest.mark.gpu
def test_build_attr_losses_defaults_to_the_card(battery):
    specs, predictors = build_attr_losses({"expression_loss": FFHQ["training_config"]["expression_loss"]})
    assert [s.name for s in specs] == ["expression_loss"]
    assert all(p.is_cuda for p in predictors["expression_loss"].parameters())


@pytest.mark.gpu
@pytest.mark.parametrize("name", NETS)
def test_f32_battery_backward_keeps_its_precision(battery, name):
    """An f32 predictor at "highest", called as the registry calls it
    (``with_predictor_precision``), in a process with TF32 on: its layers
    and the image gradient of a seeded projection equal those of a process
    with TF32 off everywhere, within this file's f32 bounds, and no farther
    than a backward that ran under the caller's TF32; the caller's setting
    is back after the backward."""
    import copy

    from gan_control_torch.utils.precision import predictor_precision_ctx, with_predictor_precision

    nets, images = battery
    module = copy.deepcopy(nets[name]).to("cuda")
    x0 = images[:2].cuda()
    guarded = with_predictor_precision(lambda m, x: m(x), "highest")

    def forward_only(m, x):
        with predictor_precision_ctx("highest"):
            return m(x)

    def run(fn, tf32):
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
        x = x0.clone().requires_grad_(True)
        feats = fn(module, x)
        feats = list(feats) if isinstance(feats, (list, tuple)) else [feats]
        gen = torch.Generator().manual_seed(NETS.index(name))
        projs = [torch.randn(f.shape, generator=gen).cuda() for f in feats]
        (grad,) = torch.autograd.grad(sum((f.float() * p).sum() for f, p in zip(feats, projs)), x)
        after = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        return [f.detach().float() for f in feats], grad.float(), after

    try:
        want_f, want_g, _ = run(guarded, False)
        got_f, got_g, after = run(guarded, True)
        _, unguarded_g, _ = run(forward_only, True)
    finally:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    assert after == (True, True)
    for g, w in zip(got_f, want_f):
        assert float((g - w).abs().max()) <= chip_smoke.PREDICTOR_RTOL * max(float(w.abs().max()), 1e-12)
    rel = float((got_g - want_g).norm() / want_g.norm())
    rel_unguarded = float((unguarded_g - want_g).norm() / want_g.norm())
    print(f"{name}: image gradient relative L2 to TF32 off: {rel:.3e} guarded, "
          f"{rel_unguarded:.3e} with the backward under the caller's TF32")
    assert rel <= chip_smoke.PREDICTOR_GRAD_REL_L2
    assert rel <= rel_unguarded


@pytest.fixture(scope="module")
def new_battery(battery):
    """The AFHQ and MetFaces nets at random init, calibrated on the same
    images."""
    _, images = battery
    nets = {}
    for name, cfg_name in chip_smoke.NEW_NETS.items():
        block = json.loads((REPO / "gan_control_tpu" / "configs" / f"{cfg_name}.json").read_text())
        _, preds = build_attr_losses({name: block["training_config"][name]}, device="cpu", seed=3)
        calibrate_battery(preds, images)
        nets[name] = preds[name]
    return nets, images


@pytest.mark.gpu
@pytest.mark.parametrize("name", NEW_NETS)
def test_new_predictor_card_matches_cpu(new_battery, name):
    nets, images = new_battery
    errs = chip_smoke.predictor_card_vs_cpu(name, nets[name], images[:2], seed=10 + NEW_NETS.index(name))
    assert errs["layers"] <= chip_smoke.PREDICTOR_RTOL
    assert errs["grad_rel_l2"] <= chip_smoke.PREDICTOR_GRAD_REL_L2


@pytest.mark.gpu
def test_augment_card_matches_cpu(battery):
    errs = chip_smoke.augment_card_vs_cpu(seed=1)
    assert max(errs.values()) <= chip_smoke.AUGMENT_RTOL
