"""The port's Hopper kernels on the card (``gpu`` marker; skip without one).

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch and the CUDA toolkit. ``tests/conftest.py``
imports JAX, so there it runs with

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py -q

Each kernel is held against its plain PyTorch version on the same inputs on
the card: f32 to 1e-6 (the same f32 arithmetic in another order), bf16 to
one bf16 rounding step (2**-7 relative). Gradients through each wrapper on
the card, first and second order, are held against autograd of the plain
version on the same inputs (f32 1e-5: the backward kernels sum in another
order). Whole-model checks compare the card (kernels, cuDNN) with the
port's CPU path in f32 with TF32 off: 1e-4 (summation order across ~16
layers).
"""

import json

import numpy as np
import pytest
import torch

from gan_control_torch.inference.controller import Controller
from gan_control_torch.models.blocks import init_params_
from gan_control_torch.models.controller import FcStack
from gan_control_torch.models.factory import build_generator, build_group_spec
from gan_control_torch.ops import kernels
from gan_control_torch.ops import modulated_conv2d
from gan_control_torch.ops.upfirdn2d import make_kernel
from gan_control_torch.utils.flax_bridge import save_flax_checkpoint

BLUR4 = (0.125, 0.375, 0.375, 0.125)

RTOL = {torch.float32: 1e-6, torch.bfloat16: 2.0**-7}


def _randn(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Triton and CUDA kernels run only on the card")
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def _close(got, want, dtype):
    scale = max(1.0, float(want.float().abs().max()))
    err = float((got.float() - want.float()).abs().max())
    assert err <= RTOL[dtype] * scale, (err, scale)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 64, 64, 64), (8, 256), (3, 5, 7, 3), (1, 1)])
def test_fused_bias_act_matches_plain_on_card(cuda_device, dtype, shape):
    x = torch.from_numpy(_randn(shape, 1)).to(cuda_device, dtype)
    b = torch.from_numpy(_randn(shape[-1:], 2)).to(cuda_device)
    before = kernels.fused_bias_act.launches
    got = kernels.fused_bias_act(x, b)
    assert kernels.fused_bias_act.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    _close(got, kernels.fused_bias_act_plain(x, b), dtype)
    torch.cuda.synchronize()


# Edges of the blur2x kernels: C of 1, 3, 4, 8, 64 and 300 (above
# blur2x_up's 256-channel tile); rows whose W*C*itemsize is no multiple of 16
# bytes (W = 4, C = 3 in bf16: 24 bytes); odd H and W; images of one pixel;
# a batch above the 65535 of one grid axis at a tiny H x W.
UP_SHAPES = [(8, 128, 128, 3), (2, 5, 7, 16), (1, 1, 1, 3),
             (2, 4, 4, 3), (3, 7, 9, 1), (2, 5, 3, 4), (2, 9, 11, 8), (2, 17, 13, 64),
             (1, 3, 5, 300), (16, 64, 64, 3), (70000, 1, 1, 3)]
DOWN_SHAPES = [(8, 256, 256, 3), (2, 6, 10, 16), (1, 2, 2, 3),
               (2, 2, 2, 1), (2, 2, 2, 8), (3, 8, 8, 3), (2, 6, 14, 4), (2, 10, 6, 64),
               (1, 4, 6, 300), (16, 128, 128, 3), (70000, 2, 2, 3)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", UP_SHAPES)
def test_blur2x_up_matches_plain_on_card(cuda_device, dtype, shape):
    x = torch.from_numpy(_randn(shape, 3)).to(cuda_device, dtype)
    before = kernels.blur2x_up.launches
    got = kernels.blur2x_up(x)
    assert kernels.blur2x_up.launches == before + 1
    n, h, w, c = shape
    assert got.shape == (n, 2 * h, 2 * w, c) and got.dtype == dtype
    _close(got, kernels.blur2x_up_plain(x), dtype)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_wrappers_refuse_other_layouts_on_card(cuda_device):
    x = torch.zeros(2, 4, 4, 8, device=cuda_device)
    with pytest.raises(ValueError):
        kernels.fused_bias_act(x.permute(0, 3, 1, 2), torch.zeros(4, device=cuda_device))
    with pytest.raises(ValueError):
        kernels.blur2x_up(x.permute(0, 3, 1, 2))
    with pytest.raises(ValueError):
        kernels.fused_bias_act(x, torch.zeros(8))  # bias on the CPU


@pytest.mark.gpu
@pytest.mark.parametrize("hw", [(9, 8), (8, 8)])
def test_modulated_conv_up_on_card_matches_cpu(cuda_device, hw):
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, *hw, 32)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((16, 32, 3, 3)).astype(np.float32))
    s = torch.from_numpy((1 + 0.5 * rng.standard_normal((2, 32))).astype(np.float32))
    k = make_kernel((1, 3, 3, 1))
    want = modulated_conv2d(x, w, s, upsample=True, blur_kernel=k)
    got = modulated_conv2d(x.to(cuda_device), w.to(cuda_device), s.to(cuda_device),
                           upsample=True, blur_kernel=k.to(cuda_device))
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_tiny_controller_card_matches_cpu(cuda_device, tmp_path):
    config = {
        "model_config": {"split_fc": True, "latent_size": 32, "size": 32, "n_mlp": 2,
                         "max_channels": 32, "mixed_precision": True},
        "training_config": {"mini_batch": 4, "sub_groups_dict": {
            "orientation": {"place_in_latent": [0, 16], "place_in_mini_batch": [0, 2]},
            "other": {"place_in_latent": [16, 32], "place_in_mini_batch": [2, 4]}}},
    }
    (tmp_path / "generator").mkdir()
    (tmp_path / "generator" / "args.json").write_text(json.dumps(config))
    gen = build_generator(config, build_group_spec(config), device="cpu", seed=0)
    save_flax_checkpoint(tmp_path / "generator" / "checkpoint", "g_ema", gen)
    head = tmp_path / "orientation_x"
    head.mkdir()
    (head / "args.json").write_text(json.dumps({"model_config": {"in_dim": 3, "n_mlp": 2, "mid_dim": 16}}))
    save_flax_checkpoint(head / "checkpoint", "controller",
                         init_params_(FcStack(3, 2, 16, 16), seed=1))
    z = _randn((2, 32), 5)
    o = _randn((2, 3), 6) * 10
    cpu = Controller(tmp_path, device="cpu", dtype=torch.float32)
    noise = [_randn(s, 7 + i) for i, s in enumerate(cpu.model.noise_shapes(1))]
    cpu.set_noise(noise)
    want, _, _ = cpu.gen_batch_by_controls(latent=z, normalize=False, orientation=o)
    for dtype, tol in ((torch.float32, 1e-4), (None, 0.05)):  # None: the config's bf16
        card = Controller(tmp_path, dtype=dtype)
        card.set_noise(noise)
        kernels.reset_launch_counts()
        got, _, _ = card.gen_batch_by_controls(latent=z, normalize=False, orientation=o)
        torch.cuda.synchronize()
        assert kernels.launch_counts() == {"fused_bias_act": 2 * 2 + 2 + 7, "fused_bias_act_grad": 0,
                                           "blur2x_up": 3, "blur2x_down": 0, "blur_sep": 0,
                                           "dequant_int8": 0}
        scale = max(1.0, float(want.abs().max()))
        assert float((got.cpu() - want).abs().max()) <= tol * scale


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 64, 64, 64), (3, 5, 7, 3), (5, 16)])
def test_fused_bias_act_grad_matches_plain_on_card(cuda_device, dtype, shape):
    g = torch.from_numpy(_randn(shape, 11)).to(cuda_device, dtype)
    x = torch.from_numpy(_randn(shape, 12)).to(cuda_device, dtype)
    b = torch.from_numpy(_randn(shape[-1:], 13)).to(cuda_device)
    gb = torch.from_numpy(_randn(shape[-1:], 14)).to(cuda_device)
    for extra in (None, gb):
        before = kernels.fused_bias_act_grad.launches
        got = kernels.fused_bias_act_grad(g, x, b, extra)
        assert kernels.fused_bias_act_grad.launches == before + 1
        _close(got, kernels.fused_bias_act_grad_plain(g, x, b, extra), dtype)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", DOWN_SHAPES)
def test_blur2x_down_matches_plain_on_card(cuda_device, dtype, shape):
    x = torch.from_numpy(_randn(shape, 15)).to(cuda_device, dtype)
    before = kernels.blur2x_down.launches
    got = kernels.blur2x_down(x)
    assert kernels.blur2x_down.launches == before + 1
    n, h, w, c = shape
    assert got.shape == (n, h // 2, w // 2, c) and got.dtype == dtype
    _close(got, kernels.blur2x_down_plain(x), dtype)
    torch.cuda.synchronize()


BLUR2X = {"up": (kernels.blur2x_up, kernels.blur2x_up_plain),
          "down": (kernels.blur2x_down, kernels.blur2x_down_plain)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [1, 3])
@pytest.mark.parametrize("which,shape", [("up", (2, 6, 4, 3)), ("up", (1, 8, 8, 8)),
                                         ("down", (2, 6, 4, 3)), ("down", (1, 8, 8, 8))])
def test_blur2x_unaligned_input_on_card(cuda_device, dtype, offset, which, shape):
    """A contiguous input that starts ``offset`` elements past an aligned
    address: its rows' 16-byte pieces sit elsewhere than the row starts, and
    the kernel's own scalar route copies the ragged ends."""
    fn, plain = BLUR2X[which]
    n = int(np.prod(shape))
    buf = torch.from_numpy(_randn((n + offset,), 17)).to(cuda_device, dtype)
    x = buf[offset:].view(shape)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    _close(fn(x), plain(x), dtype)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_blur2x_pair_in_a_cuda_graph(cuda_device, dtype):
    """Both kernels captured in one CUDA graph (the launch path reads the
    capture stream), replayed on new inputs: each equals its plain version,
    and the counters counted the captured launches only."""
    x = torch.from_numpy(_randn((4, 16, 16, 3), 18)).to(cuda_device, dtype)
    y = torch.from_numpy(_randn((4, 32, 32, 3), 19)).to(cuda_device, dtype)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kernels.blur2x_up(x), kernels.blur2x_down(y)
    torch.cuda.current_stream().wait_stream(side)
    kernels.reset_launch_counts()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        up, down = kernels.blur2x_up(x), kernels.blur2x_down(y)
    assert kernels.blur2x_up.launches == 1 and kernels.blur2x_down.launches == 1
    for seed in (20, 21):
        x.copy_(torch.from_numpy(_randn(tuple(x.shape), seed)).to(cuda_device, dtype))
        y.copy_(torch.from_numpy(_randn(tuple(y.shape), seed + 10)).to(cuda_device, dtype))
        graph.replay()
        torch.cuda.synchronize()
        _close(up, kernels.blur2x_up_plain(x), dtype)
        _close(down, kernels.blur2x_down_plain(y), dtype)
    assert kernels.blur2x_up.launches == 1 and kernels.blur2x_down.launches == 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,taps,pad", [
    ((4, 64, 64, 128), BLUR4, (2, 2)),   # a D pre-blur shape: 65 outputs, a ragged last tile
    ((4, 64, 64, 128), BLUR4, (1, 1)),   # the skip's pre-blur: 63 outputs
    ((4, 65, 65, 128), BLUR4, (1, 1)),   # their backwards: 65 and 63 in, 64 out
    ((4, 63, 63, 128), BLUR4, (2, 2)),
    ((2, 32, 32, 64), BLUR4, (2, 2)),    # the 512-px level's width, 33 outputs: two tiles
    ((2, 8, 8, 512), BLUR4, (2, 2)),
    ((2, 9, 9, 512), BLUR4, (1, 1)),
    ((2, 17, 11, 40), BLUR4, (0, 3)),    # channels not a multiple of 32 or 64
    ((1, 9, 9, 3), (0.1, 0.2, 0.3, 0.1, 0.05, 0.1, 0.1, 0.05), (7, 7)),
    ((1, 5, 6, 33), (0.5, 0.5), (1, 0)),
    ((1, 0, 5, 8), BLUR4, (2, 2)),       # an empty input: the pads alone, zeros
])
def test_blur_sep_matches_plain_on_card(cuda_device, dtype, shape, taps, pad):
    x = torch.from_numpy(_randn(shape, 16)).to(cuda_device, dtype)
    ct = tuple(reversed(taps))
    before = kernels.blur_sep.launches
    got = kernels.blur_sep(x, taps, ct, pad)
    assert kernels.blur_sep.launches == before + 1
    want = kernels.blur_sep_plain(x, taps, ct, pad)
    assert got.shape == want.shape and got.dtype == dtype
    _close(got, want, dtype)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", range(1, 9))
def test_blur_sep_every_pad_and_width_on_card(cuda_device, dtype, k):
    """Every pad pair in [0, K-1] at C = 3 and 33 (the direct variant) and
    8, 24 and 64 (the staged one), odd H and W, unequal row and column taps:
    each launches once and equals the plain version."""
    rt = tuple(0.1 * (i + 1) for i in range(k))
    ct = tuple(0.05 * (k - i) + 0.01 for i in range(k))
    for c in (3, 8, 24, 33, 64):
        x = torch.from_numpy(_randn((2, 7, 9, c), 100 + c)).to(cuda_device, dtype)
        for p0 in range(k):
            for p1 in range(k):
                if 7 + p0 + p1 < k:
                    continue
                before = kernels.blur_sep.launches
                got = kernels.blur_sep(x, rt, ct, (p0, p1))
                assert kernels.blur_sep.launches == before + 1
                _close(got, kernels.blur_sep_plain(x, rt, ct, (p0, p1)), dtype)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [1, 3])
@pytest.mark.parametrize("shape,pad", [((2, 11, 13, 64), (2, 2)), ((2, 10, 7, 40), (1, 1))])
def test_blur_sep_unaligned_input_on_card(cuda_device, dtype, offset, shape, pad):
    """A contiguous input that starts ``offset`` elements past a 16-byte
    boundary takes the direct variant, whatever C."""
    buf = torch.from_numpy(_randn((int(np.prod(shape)) + offset,), 22)).to(cuda_device, dtype)
    x = buf[offset:].view(shape)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    assert kernels.blur_sep_plan(x.shape, 4, pad, x.element_size(), x.data_ptr())[0] == 1
    _close(kernels.blur_sep(x, BLUR4, BLUR4, pad), kernels.blur_sep_plain(x, BLUR4, BLUR4, pad), dtype)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,pad", [(8, (2, 2)), (3, (1, 1))])
def test_blur_sep_batch_beyond_one_grid_axis_on_card(cuda_device, dtype, c, pad):
    x = torch.from_numpy(_randn((65537, 2, 2, c), 23)).to(cuda_device, dtype)
    _close(kernels.blur_sep(x, BLUR4, BLUR4, pad), kernels.blur_sep_plain(x, BLUR4, BLUR4, pad), dtype)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_blur_sep_in_a_cuda_graph(cuda_device, dtype):
    """Both variants captured in one CUDA graph (the staged one's tensor map
    and the taps travel in the launch's arguments), replayed on new inputs:
    each equals the plain version, and only the captured launches counted."""
    x = torch.from_numpy(_randn((2, 16, 16, 64), 24)).to(cuda_device, dtype)
    y = torch.from_numpy(_randn((2, 9, 11, 3), 25)).to(cuda_device, dtype)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kernels.blur_sep(x, BLUR4, BLUR4, (2, 2)), kernels.blur_sep(y, BLUR4, BLUR4, (1, 1))
    torch.cuda.current_stream().wait_stream(side)
    kernels.reset_launch_counts()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        bx, by = kernels.blur_sep(x, BLUR4, BLUR4, (2, 2)), kernels.blur_sep(y, BLUR4, BLUR4, (1, 1))
    assert kernels.blur_sep.launches == 2
    for seed in (26, 27):
        x.copy_(torch.from_numpy(_randn(tuple(x.shape), seed)).to(cuda_device, dtype))
        y.copy_(torch.from_numpy(_randn(tuple(y.shape), seed + 10)).to(cuda_device, dtype))
        graph.replay()
        torch.cuda.synchronize()
        _close(bx, kernels.blur_sep_plain(x, BLUR4, BLUR4, (2, 2)), dtype)
        _close(by, kernels.blur_sep_plain(y, BLUR4, BLUR4, (1, 1)), dtype)
    assert kernels.blur_sep.launches == 2


def _grads_two_orders(fn, x, extra):
    """Output, first-order gradients of a seeded projection (x and extra),
    and the double backward: the gradient of a projection of those with
    respect to the first projection's weights."""
    x = x.clone().requires_grad_(True)
    extra = [e.clone().requires_grad_(True) for e in extra]
    out = fn(x, *extra)
    g1 = torch.from_numpy(_randn(tuple(out.shape), 21)).to(out.device, out.dtype).requires_grad_(True)
    firsts = torch.autograd.grad((out.float() * g1.float()).sum(), [x, *extra], create_graph=True)
    loss2 = sum((f.float() * torch.from_numpy(_randn(tuple(f.shape), 22 + i)).to(f.device)).sum()
                for i, f in enumerate(firsts))
    (second,) = torch.autograd.grad(loss2, g1)
    return [out, *firsts, second]


GRAD_CASES = {
    "fused_bias_act": (lambda x, b: kernels.fused_bias_act(x, b), (2, 9, 9, 64), [(64,)]),
    "blur2x_up": (lambda x: kernels.blur2x_up(x), (2, 16, 16, 3), []),
    "blur2x_down": (lambda x: kernels.blur2x_down(x), (2, 32, 32, 3), []),
    "blur_sep": (lambda x: kernels.blur_sep(x, BLUR4, BLUR4, (2, 2)), (2, 16, 16, 64), []),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_gradients_through_kernels_on_card_match_plain(cuda_device, case):
    """The autograd repair: on the card each wrapper's output carries a
    gradient, equal to autograd of the plain version, to second order; each
    order ran through the kernels (launch counters)."""
    fn, shape, extra_shapes = GRAD_CASES[case]
    x = torch.from_numpy(_randn(shape, 20))
    extra = [torch.from_numpy(_randn(s, 30 + i)) for i, s in enumerate(extra_shapes)]
    want = _grads_two_orders(fn, x, extra)  # CPU: autograd of the plain version
    kernels.reset_launch_counts()
    got = _grads_two_orders(fn, x.to(cuda_device), [e.to(cuda_device) for e in extra])
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert sum(counts.values()) >= 3, counts  # forward, backward, double backward
    for g, w in zip(got, want):
        assert g.grad_fn is not None or not g.requires_grad
        scale = max(1.0, float(w.detach().abs().max()))
        assert float((g.detach().cpu().float() - w.detach().float()).abs().max()) <= 1e-5 * scale


@pytest.mark.gpu
def test_tiny_train_steps_card_match_cpu(cuda_device):
    """Every step kind of a size-16 model, from the same parameters and
    explicit random inputs, on the card and on the CPU (f32, TF32 off): the
    same losses and gradients (1e-3 of the largest entry: cuDNN's sums in
    another order through two backward passes)."""
    from gan_control_torch.models.factory import build_discriminator, build_generator
    from gan_control_torch.training import train_step as ts
    from gan_control_torch.training.state import init_gan_state

    config = {"model_config": {"size": 16, "max_channels": 32, "n_mlp": 2, "split_fc": True,
                               "latent_size": 32},
              "training_config": {"mini_batch": 4, "lr_g": 2e-3, "lr_d": 2e-3, "sub_groups_dict": {
                  "id": {"place_in_latent": [0, 16], "place_in_mini_batch": [0, 2]},
                  "other": {"place_in_latent": [16, 32], "place_in_mini_batch": [2, 4]}}}}
    spec = build_group_spec(config)
    cfg = ts.TrainStepConfig(batch=4, mini_batch=4, style_dim=32)
    z = torch.from_numpy(_randn((4, 32), 40))
    real = torch.from_numpy(_randn((4, 16, 16, 3), 41) * 0.5)
    probe = build_generator(config, spec, device="cpu")
    noise = [torch.from_numpy(_randn(s, 50 + i)) for i, s in enumerate(probe.noise_shapes(4))]
    path_noise = torch.from_numpy(_randn((2, 16, 16, 3), 42))
    results = {}
    for dev in ("cpu", "cuda"):
        mv = lambda t: t.to(dev)  # noqa: E731
        runs = {
            "d_step": lambda st: ts.d_step(st, cfg, spec, mv(real), (mv(z),), noise=[mv(n) for n in noise]),
            "d_reg_step": lambda st: ts.d_reg_step(st, cfg, mv(real)),
            "g_step": lambda st: ts.g_step(st, cfg, spec, (mv(z),), noise=[mv(n) for n in noise]),
            "g_reg_step": lambda st: ts.g_reg_step(st, cfg, (mv(z[:2]),), noise=[mv(n[:2]) for n in noise],
                                                   path_noise=mv(path_noise)),
        }
        for kind, run in runs.items():
            g = build_generator(config, spec, device=dev, seed=0)
            with torch.no_grad():
                for m in g.modules():
                    if type(m).__name__ == "NoiseInjection":
                        m.weight.fill_(0.3)
            st = init_gan_state(g, build_discriminator(config, device=dev, seed=1),
                                config["training_config"])
            metrics = {k: float(v) for k, v in run(st).items()}
            grads = {f"{p}.{n}": t.grad.cpu() for p, mod in (("g", st.generator), ("d", st.discriminator))
                     for n, t in mod.named_parameters() if t.grad is not None}
            results[(dev, kind)] = (metrics, grads)
    for kind in ("d_step", "d_reg_step", "g_step", "g_reg_step"):
        (mc, gc), (mg, gg) = results[("cpu", kind)], results[("cuda", kind)]
        assert mc.keys() == mg.keys() and gc.keys() == gg.keys()
        for k in mc:
            assert abs(mc[k] - mg[k]) <= 1e-3 * max(1.0, abs(mc[k])), (kind, k)
        for n in gc:
            scale = max(float(gc[n].abs().max()), 1e-8)
            assert float((gg[n] - gc[n]).abs().max()) <= 1e-3 * scale, (kind, n)


@pytest.mark.gpu
def test_device_feeder_pins_and_copies_in_order(cuda_device):
    """The trainer's feeder on the card: batches arrive in the loader's
    order and equal the host arrays, each copied from a pinned buffer that
    is kept until its copy has completed, while the stream is busy with
    other work."""
    from gan_control_torch.data.prefetch import DeviceFeeder

    batches = [_randn((4, 64, 64, 3), 200 + i) for i in range(12)]
    feeder = DeviceFeeder(iter(batches), cuda_device, depth=2)
    busy = torch.randn(2048, 2048, device=cuda_device)
    try:
        for want in batches:
            for _ in range(4):
                busy = torch.tanh(busy @ busy * 1e-3)
            got = feeder.next()
            assert got.device.type == "cuda" and got.dtype == torch.float32
            assert all(p.is_pinned() for p, _ in feeder._in_flight)
            np.testing.assert_array_equal(got.cpu().numpy(), want)
        with pytest.raises(StopIteration):
            feeder.next()
    finally:
        feeder.close()
    assert not feeder._in_flight
