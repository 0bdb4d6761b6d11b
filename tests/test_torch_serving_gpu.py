"""The port's serving path on the card (``gpu`` marker; skip without one).

This file imports neither JAX nor the JAX package; on a machine with the
card it runs with

    python -m pytest --noconftest -m gpu tests/test_torch_serving_gpu.py -q

A tiny controller directory (a 16-px split-mapping generator and an
orientation head, non-zero noise weights) is written with the port's own
msgpack writer. Each request replays a captured CUDA graph; the checks:
replay against the eager ``gen_batch_by_controls`` on the same z and
static noise (f32, TF32 off: the same kernels on the same inputs, held to
1e-6 of max|img|, the kernels' own f32 bound), one capture per (key,
bucket), results that outlive the next request, the per-row noise on the
card (the CPU's draw to 1e-5: the same integer hash, then log and cos of
another library), and an exported program replayed against the live path
(1e-6).
"""

import json

import numpy as np
import pytest
import torch

from gan_control_torch.inference.exported import load_exported_serving
from gan_control_torch.inference.row_noise import row_noise
from gan_control_torch.inference.serving import ServingController
from gan_control_torch.models.blocks import NoiseInjection, init_params_
from gan_control_torch.models.controller import FcStack
from gan_control_torch.models.factory import build_generator, build_group_spec
from gan_control_torch.utils.flax_bridge import save_flax_checkpoint

STYLE = 32
SIZE = 16
RTOL = 1e-6


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Triton and CUDA kernels run only on the card")
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


@pytest.fixture
def controller_dir(tmp_path):
    config = {
        "model_config": {"split_fc": True, "latent_size": STYLE, "size": SIZE, "n_mlp": 2,
                         "max_channels": 32},
        "training_config": {"mini_batch": 4, "sub_groups_dict": {
            "orientation": {"place_in_latent": [0, 16], "place_in_mini_batch": [0, 2]},
            "other": {"place_in_latent": [16, 32], "place_in_mini_batch": [2, 4]}}},
    }
    (tmp_path / "generator").mkdir()
    (tmp_path / "generator" / "args.json").write_text(json.dumps(config))
    gen = build_generator(config, build_group_spec(config), device="cpu", seed=0)
    with torch.no_grad():
        for m in gen.modules():
            if isinstance(m, NoiseInjection):
                m.weight.fill_(0.7)
    save_flax_checkpoint(tmp_path / "generator" / "checkpoint", "g_ema", gen)
    head = tmp_path / "orientation_x"
    head.mkdir()
    (head / "args.json").write_text(json.dumps({"model_config": {"in_dim": 3, "n_mlp": 2, "mid_dim": 16}}))
    save_flax_checkpoint(head / "checkpoint", "controller", init_params_(FcStack(3, 2, 16, 16), seed=1))
    return tmp_path


def _randn(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, rtol=RTOL):
    err = float(np.abs(got.astype(np.float64) - want.astype(np.float64)).max())
    assert err <= rtol * max(1.0, float(np.abs(want).max())), err


@pytest.mark.gpu
def test_replay_equals_eager_and_captures_once(cuda_device, controller_dir):
    serve = ServingController(controller_dir, buckets=(2, 4), dtype=torch.float32)
    serve.warmup()
    keys = sorted(serve._serve_cache)
    assert [k[4] for k in keys] == [2, 4]
    graphs = {k: e.graph for k, e in serve._serve_cache.items()}
    for e in serve._serve_cache.values():
        # per request: the mapping's 4 and the head's 2 layers, 5 StyledConvs; 2 ToRGB skips
        assert e.graph is not None and e.launches["fused_bias_act"] == 4 + 2 + 5
        assert e.launches["blur2x_up"] == 2
    for n in (2, 3, 4):
        z, o = _randn((n, STYLE), n), _randn((n, 3), 10 + n) * 10
        img, _, w = serve.generate(latent=z, orientation=o)
        # eager at the bucket's batch, padded with zeros as the graph's inputs
        # are, so that cuDNN runs the same algorithms
        b = serve.bucket_for(n)
        zp, op = np.zeros((b, STYLE), np.float32), np.zeros((b, 3), np.float32)
        zp[:n], op[:n] = z, o
        want, _, want_w = serve.gen_batch_by_controls(latent=zp, orientation=op)
        _close(img, want[:n].cpu().numpy())
        _close(w, want_w[:n].cpu().numpy())
    assert sorted(serve._serve_cache) == keys  # no capture on later requests
    assert all(serve._serve_cache[k].graph is g for k, g in graphs.items())


@pytest.mark.gpu
def test_a_result_survives_the_next_request(cuda_device, controller_dir):
    serve = ServingController(controller_dir, buckets=(4,), dtype=torch.float32)
    z, o = _randn((3, STYLE), 1), _randn((3, 3), 2)
    first, _, first_w = serve.generate(latent=z, orientation=o)
    kept = first.copy()
    serve.generate(latent=_randn((4, STYLE), 3), orientation=_randn((4, 3), 4))
    np.testing.assert_array_equal(first, kept)
    again, _, again_w = serve.generate(latent=z, orientation=o)
    np.testing.assert_array_equal(again, first)
    np.testing.assert_array_equal(again_w, first_w)


@pytest.mark.gpu
def test_row_noise_on_the_card(cuda_device, controller_dir):
    shapes = [(8, 4, 4, 1), (8, 64, 64, 1)]
    seed = torch.tensor([987654321], dtype=torch.int64)
    card = row_noise(seed.cuda(), shapes)
    cpu = row_noise(seed, shapes)
    short = row_noise(seed.cuda(), [(3, *s[1:]) for s in shapes])
    for c, p, s in zip(card, cpu, short):
        assert c.is_cuda and torch.equal(c[:3], s)
        torch.testing.assert_close(c.cpu(), p, rtol=1e-5, atol=1e-5)
    (big,) = row_noise(seed.cuda(), [(16, 128, 128, 1)])
    assert abs(float(big.mean())) < 0.01 and abs(float(big.std()) - 1.0) < 0.01
    # one row at bucket 1 and the first of four at bucket 4: the same image,
    # up to cuDNN's algorithms for another batch (f32, TF32 off)
    serve = ServingController(controller_dir, buckets=(1, 4), dtype=torch.float32)
    z = _randn((4, STYLE), 5)
    one, _, _ = serve.generate(latent=z[:1], static_noise=False, generator=torch.Generator().manual_seed(9))
    four, _, _ = serve.generate(latent=z, static_noise=False, generator=torch.Generator().manual_seed(9))
    _close(one, four[:1], 1e-4)


@pytest.mark.gpu
def test_exported_program_replayed(cuda_device, controller_dir, tmp_path):
    serve = ServingController(controller_dir, buckets=(4,), dtype=torch.float32)
    for static_noise in (True, False):
        out = tmp_path / f"art_{static_noise}"
        manifest = serve.export_artifacts(out, groups=["orientation"], buckets=(4,),
                                          static_noise=static_noise)
        assert manifest["artifacts"][0]["device"] == "cuda"
        ex = load_exported_serving(out)
        z, o = _randn((3, STYLE), 6), _randn((3, 3), 7)
        got, _, got_w = ex.generate(latent=z, generator=torch.Generator().manual_seed(2), orientation=o)
        want, _, want_w = serve.generate(latent=z, generator=torch.Generator().manual_seed(2),
                                         static_noise=static_noise, orientation=o)
        (entry,) = ex._cache.values()
        assert entry.graph is not None
        assert entry.launches == {**entry.launches, "fused_bias_act": 11, "blur2x_up": 2}
        _close(got, want)
        _close(got_w, want_w)
    with pytest.raises(ValueError, match="exported on"):
        load_exported_serving(out, device="cpu")
