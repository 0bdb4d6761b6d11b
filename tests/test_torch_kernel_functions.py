"""The kernels' autograd Functions on the CPU.

On a CUDA tensor every wrapper of ``gan_control_torch/ops/kernels.py`` runs
its kernel inside a ``torch.autograd.Function`` whose backward launches a
kernel again through a Function. Here those Functions are driven on the CPU
with each plain version standing in for its kernel launcher, and their
outputs, gradients and second-order gradients are held against autograd of
the plain versions. That pins the backward formulas (reversed taps,
complementary pads, the adjoint pair ``blur2x_up``/``blur2x_down``, the
``(dx, db)`` pair of ``fused_bias_act``) without a card; the kernels
themselves are held against the plain versions on the card
(``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``).

Tolerance: f32 arithmetic in another order, 1e-5 of the largest entry;
bf16 storage, one bf16 step (2**-7) of the largest entry.
"""

import ctypes
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from gan_control_torch.models.factory import build_discriminator, build_generator, build_group_spec
from gan_control_torch.ops import kernels
from gan_control_torch.training import train_step as ts
from gan_control_torch.training.state import init_gan_state

TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0**-7}
CONFIGS = Path(__file__).resolve().parent.parent / "gan_control_tpu" / "configs"


def _randn(shape, seed, dtype=torch.float32):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32)).to(dtype)


def _drive_functions(monkeypatch):
    monkeypatch.setattr(kernels, "_plain_path", lambda x: False)
    for name, plain in (("_cuda_fused_bias_act", kernels.fused_bias_act_plain),
                        ("_cuda_fused_bias_act_grad", kernels.fused_bias_act_grad_plain),
                        ("_cuda_blur2x_up", kernels._up_plain),
                        ("_cuda_blur2x_down", kernels._down_plain),
                        ("_cuda_blur_sep", kernels.blur_sep_plain)):
        monkeypatch.setattr(kernels, name, plain)


def _orders(fn, x, extra=(), seed=0):
    """Output, first-order gradients (x and ``extra``) of a seeded
    projection, and the gradient of a seeded projection of those with
    respect to the projection's weights (the double backward)."""
    x = x.clone().requires_grad_(True)
    extra = [e.clone().requires_grad_(True) for e in extra]
    out = fn(x, *extra)
    g1 = _randn(out.shape, seed + 1, out.dtype).requires_grad_(True)
    firsts = torch.autograd.grad((out.float() * g1.float()).sum(), [x, *extra], create_graph=True)
    loss2 = sum((f.float() * _randn(f.shape, seed + 2 + i)).sum() for i, f in enumerate(firsts))
    (second,) = torch.autograd.grad(loss2, g1)
    return [out, *firsts, second]


def _compare(plain, funcs, dtype):
    assert len(plain) == len(funcs)
    for p, f in zip(plain, funcs):
        assert p.shape == f.shape and p.dtype == f.dtype
        scale = max(1.0, float(p.float().abs().max()))
        assert float((p.float() - f.float()).abs().max()) <= TOL[dtype] * scale


CASES = {
    "fused_bias_act": (lambda x, b: kernels.fused_bias_act(x, b), (2, 5, 6, 8), ((8,),)),
    "fused_bias_act_rows": (lambda x, b: kernels.fused_bias_act(x, b), (7, 16), ((16,),)),
    "blur2x_up": (lambda x: kernels.blur2x_up(x), (2, 5, 6, 3), ()),
    "blur2x_down": (lambda x: kernels.blur2x_down(x), (2, 8, 6, 3), ()),
    "blur_sep_22": (lambda x: kernels.blur_sep(x, (0.125, 0.375, 0.375, 0.125),
                                               (0.125, 0.375, 0.375, 0.125), (2, 2)), (2, 9, 7, 5), ()),
    "blur_sep_11": (lambda x: kernels.blur_sep(x, (0.125, 0.375, 0.375, 0.125),
                                               (0.125, 0.375, 0.375, 0.125), (1, 1)), (2, 8, 8, 4), ()),
    "blur_sep_asym": (lambda x: kernels.blur_sep(x, (0.1, 0.2, 0.7), (0.5, 0.25, 0.25), (0, 2)),
                      (1, 6, 5, 2), ()),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(CASES))
def test_function_orders_match_autograd_of_plain(monkeypatch, case, dtype):
    fn, shape, extra_shapes = CASES[case]
    x = _randn(shape, 0, dtype)
    extra = [_randn(s, 10 + i) for i, s in enumerate(extra_shapes)]
    plain = _orders(fn, x, extra)
    _drive_functions(monkeypatch)
    _compare(plain, _orders(fn, x, extra), dtype)


def test_fused_bias_act_grad_mask_is_x_plus_b_at_least_zero():
    """The gradient's gain follows ``x + b >= 0`` as the forward's, true at
    0 and at -0.0 (JAX's ``y >= 0``)."""
    x = torch.tensor([[-1.0, 0.0, -0.0, 2.0, 0.5]])
    b = torch.tensor([1.0, 0.0, 0.0, -2.0, -1.0])
    g = torch.ones_like(x)
    got = kernels.fused_bias_act_grad(g, x, b, negative_slope=0.2, scale=2.0)
    assert torch.equal(got, torch.tensor([[2.0, 2.0, 2.0, 2.0, 0.4]]))
    gb = torch.tensor([1.0, 1.0, 1.0, 1.0, 1.0])
    got = kernels.fused_bias_act_grad(g, x, b, gb, negative_slope=0.2, scale=2.0)
    assert torch.equal(got, torch.tensor([[4.0, 4.0, 4.0, 4.0, 0.8]]))


def test_functions_launch_only_for_needed_gradients(monkeypatch):
    """The gradient kernel's own backward launches only when its upstream
    gradient needs one (its mask input takes none)."""
    calls = []
    _drive_functions(monkeypatch)
    monkeypatch.setattr(kernels, "_cuda_fused_bias_act_grad",
                        lambda *a: calls.append(1) or kernels.fused_bias_act_grad_plain(*a))
    x = _randn((3, 4), 0).requires_grad_(True)
    b = torch.zeros(4, requires_grad=True)
    for g_needs_grad, launches in ((False, 1), (True, 2)):
        calls.clear()
        g = torch.ones(3, 4, requires_grad=g_needs_grad)
        dx, db = torch.autograd.grad(kernels.fused_bias_act(x, b), [x, b], g, create_graph=True)
        if dx.requires_grad:
            (dx.sum() + db.sum()).backward()
        assert len(calls) == launches


def test_blur2x_coefficients_are_cached_and_reach_the_launchers(monkeypatch):
    """The coefficients are computed once per tap tuple and equal the formula
    (normalised taps, reversed; gain 2 per axis for up). Each backward hands
    its launcher the forward's coefficients reversed, and every order
    launches once: forward, backward and double backward of each kernel."""
    taps = (1, 3, 3, 1)
    k = np.asarray(taps, np.float64) / 8.0
    up, down = kernels._up_coefs(taps), kernels._down_coefs(taps)
    assert up == tuple(float(v) for v in 2.0 * k[::-1])
    assert down == tuple(float(v) for v in k[::-1])
    assert kernels._up_coefs((1.0, 3.0, 3.0, 1.0)) is up
    assert kernels._down_coefs(tuple([1, 3, 3, 1])) is down
    assert kernels._reversed(up) is kernels._reversed(up)

    _drive_functions(monkeypatch)
    calls = []

    def recorder(which, plain, counter):
        def launch(x, coefs):
            calls.append((which, coefs))
            counter.launches += 1
            return plain(x, coefs)
        return launch

    monkeypatch.setattr(kernels, "_cuda_blur2x_up", recorder("up", kernels._up_plain, kernels.blur2x_up))
    monkeypatch.setattr(kernels, "_cuda_blur2x_down",
                        recorder("down", kernels._down_plain, kernels.blur2x_down))
    rev_up, rev_down = tuple(reversed(up)), tuple(reversed(down))
    for fn, shape, want in (
            (kernels.blur2x_up, (2, 3, 5, 3), [("up", up), ("down", rev_up), ("up", up)]),
            (kernels.blur2x_down, (2, 4, 6, 3), [("down", down), ("up", rev_down), ("down", down)])):
        calls.clear()
        kernels.reset_launch_counts()
        _orders(fn, _randn(shape, 0))
        assert calls == want
        counts = kernels.launch_counts()
        assert (counts["blur2x_up"], counts["blur2x_down"]) == (
            sum(c[0] == "up" for c in want), sum(c[0] == "down" for c in want))
    # without a gradient to record, the wrapper calls the launcher alone
    calls.clear()
    with torch.no_grad():
        out = kernels.blur2x_up(_randn((1, 2, 2, 3), 1).requires_grad_(True))
    assert out.grad_fn is None and calls == [("up", up)]


BLUR4 = (0.125, 0.375, 0.375, 0.125)
# the discriminator's pre-blur levels at FFHQ-512, channel multiplier 2: (size, C)
D_LEVELS = [(512, 64), (256, 128), (128, 256), (64, 512), (32, 512), (16, 512), (8, 512)]


def _path_blur_sep_shapes():
    """The 28 blur_sep launches of a D forward and backward at batch 16:
    per level the conv2 and skip pre-blurs and their backwards."""
    for s, c in D_LEVELS:
        yield (16, s, s, c), (2, 2)
        yield (16, s, s, c), (1, 1)
        yield (16, s + 1, s + 1, c), (1, 1)
        yield (16, s - 1, s - 1, c), (2, 2)


@pytest.mark.parametrize("itemsize", [2, 4])
def test_blur_sep_plan_on_the_path_stages_vectors_in_bands_of_about_8_rows(itemsize):
    """Every path shape takes the staged variant (a 16-byte vector per
    thread); its bands split the output rows evenly, about 8 rows each."""
    # output height -> rows per band, where it is not 8
    uneven = {33: 7, 17: 6, 9: 5, 7: 7}
    shapes = list(_path_blur_sep_shapes())
    assert len(shapes) == 28
    for shape, pad in shapes:
        ho = shape[1] + pad[0] + pad[1] - 3
        lanes, rows = kernels.blur_sep_plan(shape, 4, pad, itemsize, 1 << 20)
        assert (lanes, rows) == (16 // itemsize, uneven.get(ho, 8)), (shape, pad)
        assert -(-ho // rows) == -(-ho // 8)  # as many bands as of 8 rows, evened out


@pytest.mark.parametrize("shape,pad,itemsize,address,want", [
    # C no multiple of the vector: the direct variant, one channel a thread,
    # rows for about BLUR_SEP_THREADS threads
    ((16, 64, 64, 3), (2, 2), 2, 0, (1, 2)),
    ((16, 32, 32, 33), (1, 1), 2, 0, (1, 4)),
    ((2, 17, 11, 33), (0, 3), 4, 0, (1, 1)),
    ((16, 512, 512, 3), (2, 2), 4, 0, (1, 16)),
    # C = 40: a vector in bf16 (5 of 8) and in f32 (10 of 4)
    ((2, 17, 11, 40), (0, 3), 2, 0, (8, 6)),
    ((2, 17, 11, 40), (0, 3), 4, 0, (4, 6)),
    # a 16-byte-misaligned input: direct, whatever C
    ((16, 64, 64, 512), (2, 2), 2, 2, (1, 16)),
    ((2, 8, 8, 64), (1, 1), 4, 4, (1, 1)),
    ((2, 8, 8, 64), (1, 1), 4, 8, (1, 1)),
    ((2, 8, 8, 64), (1, 1), 4, 48, (4, 7)),
    # a batch beyond one grid axis at a tiny image
    ((65537, 2, 2, 8), (2, 2), 2, 0, (8, 3)),
    ((65537, 2, 2, 3), (1, 1), 2, 0, (1, 2)),
])
def test_blur_sep_plan_off_the_path(shape, pad, itemsize, address, want):
    assert kernels.blur_sep_plan(shape, 4, pad, itemsize, address) == want


def test_blur_sep_host_taps_are_cached_in_one_array():
    rt, ct = (0.1, 0.2, 0.7), (0.5, 0.25, 0.25)
    arr, addr = kernels._host_taps(rt, ct)
    assert kernels._host_taps(rt, ct)[0] is arr
    assert addr == ctypes.addressof(arr)
    np.testing.assert_array_equal(np.frombuffer(arr, np.float32),
                                  np.float32([*rt, 0, 0, 0, 0, 0, *ct, 0, 0, 0, 0, 0]))


def test_blur_sep_launches_without_the_function_when_nothing_is_recorded(monkeypatch):
    """Without a gradient to record, the wrapper calls the launcher once and
    the output has no ``grad_fn``; with one, the forward, backward and double
    backward launch once each (taps reversed and pads ``K-1-p`` in the
    backward) and the gradients equal autograd of the plain version."""
    rt, ct, pad = (0.1, 0.2, 0.7), (0.5, 0.25, 0.25), (0, 2)
    x = _randn((2, 6, 5, 3), 0)
    want = _orders(lambda a: kernels.blur_sep(a, rt, ct, pad), x)
    _drive_functions(monkeypatch)
    calls = []

    def launch(x, row_taps, col_taps, pad):
        calls.append((row_taps, col_taps, pad))
        kernels.blur_sep.launches += 1
        return kernels.blur_sep_plain(x, row_taps, col_taps, pad)

    monkeypatch.setattr(kernels, "_cuda_blur_sep", launch)
    kernels.reset_launch_counts()
    for no_grad, needs_grad in ((True, True), (False, False)):
        calls.clear()
        with torch.set_grad_enabled(not no_grad):
            out = kernels.blur_sep(x.clone().requires_grad_(needs_grad), rt, ct, pad)
        assert out.grad_fn is None and calls == [(rt, ct, pad)]
        assert torch.equal(out, kernels.blur_sep_plain(x, rt, ct, pad))
    assert kernels.launch_counts()["blur_sep"] == 2
    calls.clear()
    kernels.reset_launch_counts()
    got = _orders(lambda a: kernels.blur_sep(a, rt, ct, pad), x)
    assert calls == [(rt, ct, pad), (rt[::-1], ct[::-1], (2, 0)), (rt, ct, pad)]
    assert kernels.launch_counts()["blur_sep"] == 3
    _compare(want, got, torch.float32)


def _all_step_grads(config: dict, seed: int = 0) -> dict:
    """Metrics and gradients of each step kind of a size-16 model, each from
    the same initial state (noise weights 0.3), every random input explicit."""
    spec = build_group_spec(config)
    cfg = ts.TrainStepConfig(batch=16, mini_batch=16)
    rng = np.random.default_rng(seed)
    z = torch.from_numpy(rng.standard_normal((16, 512)).astype(np.float32))
    real = torch.from_numpy(rng.standard_normal((16, 16, 16, 3)).astype(np.float32) * 0.5)
    probe = build_generator(config, spec, device="cpu")
    noise = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in probe.noise_shapes(16)]
    path_noise = torch.from_numpy(rng.standard_normal((8, 16, 16, 3)).astype(np.float32))
    runs = {
        "d_step": lambda st: ts.d_step(st, cfg, spec, real, (z,), noise=noise),
        "d_reg_step": lambda st: ts.d_reg_step(st, cfg, real),
        "g_step": lambda st: ts.g_step(st, cfg, spec, (z,), noise=noise),
        "g_reg_step": lambda st: ts.g_reg_step(st, cfg, (z[:8],), noise=[n[:8] for n in noise],
                                               path_noise=path_noise),
    }
    out = {}
    for kind, run in runs.items():
        g = build_generator(config, spec, device="cpu", seed=seed)
        with torch.no_grad():
            for m in g.modules():
                if type(m).__name__ == "NoiseInjection":
                    m.weight.fill_(0.3)
        st = init_gan_state(g, build_discriminator(config, device="cpu", seed=seed + 1),
                            config["training_config"])
        metrics = {k: float(v) for k, v in run(st).items()}
        grads = {f"{p}.{n}": t.grad for p, mod in (("g", st.generator), ("d", st.discriminator))
                 for n, t in mod.named_parameters() if t.grad is not None}
        out[kind] = (metrics, grads)
    return out


def test_step_gradients_through_the_kernel_functions(monkeypatch):
    """Every step kind, once on the plain path (autograd of the plain
    versions) and once through the kernels' autograd Functions (their
    backward and double backward, the plain versions in the launchers'
    place): the same losses and gradients, f32 summation order apart."""
    config = json.loads((CONFIGS / "ffhq.json").read_text())
    config["model_config"].update(size=16, max_channels=16, n_mlp=2, mixed_precision=False)
    plain = _all_step_grads(config)
    _drive_functions(monkeypatch)
    funcs = _all_step_grads(config)
    for kind, (pm, pg) in plain.items():
        fm, fg = funcs[kind]
        assert pm.keys() == fm.keys() and pg.keys() == fg.keys(), kind
        for k in pm:
            np.testing.assert_allclose(fm[k], pm[k], rtol=1e-5, err_msg=f"{kind} {k}")
        for n, p in pg.items():
            scale = max(float(p.abs().max()), 1e-12)
            assert float((fg[n] - p).abs().max()) <= 1e-5 * scale, (kind, n)
