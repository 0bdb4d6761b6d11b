"""The evaluation path on the card (``gpu`` marker; skip without one).

This file imports neither JAX nor the JAX package; on a machine with a card
run it with

    python -m pytest --noconftest tests/test_torch_eval_gpu.py -q

The FID net (random init) on the card against the CPU at batch 2 and 512
px, f32 with TF32 off, to 1e-3 of the largest feature (``chip_smoke``'s
check); and one FID chunk of the FFHQ-512 generator launching exactly the
kernels derived from its modules, every launch a kernel (no plain
version on the card).
"""

import json
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

FFHQ = json.loads((REPO / "gan_control_tpu" / "configs" / "ffhq.json").read_text())


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from gan_control_torch.ops import kernels

    kernels.build()
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


@pytest.mark.gpu
def test_inception_card_matches_cpu(card):
    assert chip_smoke.inception_card_vs_cpu(seed=1) <= chip_smoke.PREDICTOR_RTOL


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [16, 20])
def test_fid_chunk_launches_the_derived_kernels(card, chunk):
    from collections import Counter

    from gan_control_torch.evaluation import fid as fid_lib
    from gan_control_torch.evaluation.inception import load_inception
    from gan_control_torch.models.factory import build_generator, build_group_spec

    g = build_generator(FFHQ, build_group_spec(FFHQ), device="cuda")
    run = fid_lib.make_gen_feature_fn(g, load_inception("__random__", "cuda"), chunk)
    gen = torch.Generator(device="cuda").manual_seed(0)
    seen = Counter()
    got = chip_smoke.launches_of(lambda: run(gen), seen)
    n_map, n_conv, n_up = chip_smoke.g_counts(g)
    assert got == chip_smoke.row(n_map + n_conv, 0, n_up, 0)
    assert {shape[0] for _, shape, *_ in seen} == {chunk}
    feats = run(gen)
    assert feats.shape == (chunk, 2048) and bool(torch.isfinite(feats).all())
