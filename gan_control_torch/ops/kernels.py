"""The Hopper kernels of the port, their plain PyTorch versions, their
autograd Functions, builds and launch counters.

Every TPU kernel of ``gan_control_tpu/ops/pallas_kernels.py`` has a kernel
written for the H100 here:

  - ``fused_bias_act`` (Pallas ``fused_bias_act``, :86): Triton, source in
    ``csrc/fused_bias_act.py``; its gradient ``fused_bias_act_grad`` is a
    second Triton kernel in the same file. Bound by device-memory bytes.
  - ``blur2x_up`` (Pallas ``blur2x_up``, :215): CUDA C++, ``csrc/blur2x_up.cu``.
  - ``blur2x_down`` (Pallas ``blur2x_down``, :149): CUDA C++,
    ``csrc/blur2x_down.cu``. It is the adjoint of ``blur2x_up`` and the
    other way round, so the two are each other's backward.
  - ``blur_sep`` (Pallas ``blur_sep`` and its custom VJP, :317-384): CUDA
    C++, ``csrc/blur_sep.cu``; its backward is the same kernel with the taps
    reversed and the pads ``K-1-p``. Two variants, both counted in
    ``blur_sep.launches``: 16-byte channel vectors per thread, or one
    channel per thread for any ``C`` and alignment (:func:`blur_sep_plan`).

One more kernel has no Pallas counterpart: ``dequant_int8`` (Triton,
``csrc/dequant_int8.py``) dequantises the int8 store of the frozen
predictor battery (``losses/int8_storage.py``) in one launch, the work the
JAX package leaves to an XLA convert per tensor
(``gan_control_tpu/losses/registry.py:148``). It takes no gradient: the
battery is frozen.

The CUDA sources are built with ``nvcc`` into shared libraries with a plain
C interface, bound through ``ctypes``, for ``sm_90a``.

Each public wrapper takes its plain version only for a tensor on the CPU,
where autograd differentiates the plain version. For a CUDA tensor it runs
the kernel inside a ``torch.autograd.Function`` whose backward is again a
kernel launched through a Function, so the backward can itself be
differentiated (R1 and path length differentiate it a second time). There
is no fallback: a CUDA tensor launches the kernel or raises (``blur2x_up``,
``blur2x_down`` and ``blur_sep`` call their launchers without the Function
when their input needs no gradient or autograd is off). Each wrapper checks the
layout it takes (the channel is the innermost physical axis: NHWC or
``[rows, C]``, contiguous) and raises on any other, on every device.
``<wrapper>.launches`` counts kernel launches and nothing else;
the counting happens in the ``_cuda_*`` launchers, which the wrappers and
Functions reach through :func:`_launch`. Under a work accountant
(``utils/accounting.py``) each launch reports :func:`kernel_work`, and a
CPU tensor takes the Functions with the plain versions in the launchers'
place, so a step counts the same work on the CPU and on the card. The
Functions do not
materialize missing gradients: a backward that receives none (a branch of
a double backward that no parameter depends on) launches nothing.

For ``torch.export`` the two kernels of the generation path,
``fused_bias_act`` and ``blur2x_up``, are also custom ops
(``gan_control_torch::fused_bias_act`` and ``::blur2x_up``): while a program
is exported the wrappers call them, so the exported graph holds them as
nodes; an op runs the same launcher on CUDA tensors and the plain version
on CPU tensors.

The CUDA libraries are built at first use (or by :func:`build`) into
``build/gan_control_torch/`` of the checkout, under a name that carries a
hash of the source, so a changed source is never served by a stale build.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import importlib.util
import math
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from gan_control_torch.utils import accounting

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "gan_control_torch"
_SQRT2 = math.sqrt(2.0)
_DTYPES = (torch.float32, torch.bfloat16)

# CUDA sources built into one shared library each
_CUDA_SOURCES = {
    "blur2x_up": "blur2x_up.cu",
    "blur2x_down": "blur2x_down.cu",
    "blur_sep": "blur_sep.cu",
}
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# the blur_sep kernel keeps up to 8 taps per axis in registers
BLUR_SEP_MAX_TAPS = 8


def _check_dtype(name: str, x: torch.Tensor) -> None:
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {x.dtype} not supported (float32, bfloat16)")


def _check_device(name: str, x: torch.Tensor) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"{name}: tensors on {x.device} are not supported")


def _check_nhwc(name: str, x: torch.Tensor) -> None:
    _check_device(name, x)
    _check_dtype(name, x)
    if x.ndim != 4 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous NHWC tensor")


def _plain_path(x: torch.Tensor) -> bool:
    """A wrapper runs its plain version for a tensor on the CPU, and only
    there; while a work accountant is active (``utils/accounting.py``) a CPU
    tensor takes the autograd Functions with the plain versions in the
    launchers' place, the structure the card runs. (Tests substitute this to
    drive the Functions on the CPU likewise.)"""
    return x.device.type == "cpu" and accounting.active() is None


def _require_cuda(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise RuntimeError(f"{name}: the kernel takes CUDA tensors, got {t.device}")


# ---------------------------------------------------------------------------
# builds
# ---------------------------------------------------------------------------


def _lib_path(name: str) -> Path:
    src = (_CSRC / _CUDA_SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build(names=None) -> dict[str, dict]:
    """Compile the CUDA libraries that are not built yet, one ``nvcc`` per
    source, all started together. Returns ``{name: {"seconds", "log"}}``
    for the ones compiled now (``-Xptxas -v`` register and spill report in
    ``log``). Raises if a compile fails."""
    names = list(_CUDA_SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_CSRC / _CUDA_SOURCES[name])]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    report = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}:\n{log}")
            continue
        os.replace(tmp, out)
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("\n".join(failed))
    return report


_C_INT, _C_PTR = ctypes.c_int, ctypes.c_void_p
# per library: its entry points (one per storage type) and their arguments
_C_SIGNATURES = {
    # x, out, n, h, w, c, the 4 coefficients (host array), stream
    "blur2x_up": [_C_PTR, _C_PTR] + [_C_INT] * 4 + [_C_PTR, _C_PTR],
    "blur2x_down": [_C_PTR, _C_PTR] + [_C_INT] * 4 + [_C_PTR, _C_PTR],
    # x, out, n, h, w, c, k, p0, p1, lanes, rows, the taps (host array), stream
    "blur_sep": [_C_PTR, _C_PTR] + [_C_INT] * 9 + [_C_PTR, _C_PTR],
}


@functools.cache
def _cuda_lib(name: str) -> ctypes.CDLL:
    build([name])
    lib = ctypes.CDLL(str(_lib_path(name)))
    for suffix in ("f32", "bf16"):
        fn = getattr(lib, f"{name}_{suffix}")
        fn.argtypes = _C_SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _entry(name: str, dtype: torch.dtype):
    """A library's C entry point for a storage type, resolved once."""
    return getattr(_cuda_lib(name), f"{name}_{'f32' if dtype == torch.float32 else 'bf16'}")


def _check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")


@functools.cache
def _triton_module(name: str):
    """Load a Triton kernel source from ``csrc/`` (imports ``triton``)."""
    spec = importlib.util.spec_from_file_location(
        f"gan_control_torch_csrc_{name}", _CSRC / f"{name}.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def contiguous_grad(g: torch.Tensor) -> torch.Tensor:
    """Gradients from cuDNN may arrive in another memory layout; the
    kernels take the channel-last buffer only, so a backward makes such a
    gradient contiguous here and counts the copy in ``.copies``."""
    if g.is_contiguous():
        return g
    contiguous_grad.copies += 1
    return g.contiguous()


contiguous_grad.copies = 0


# ---------------------------------------------------------------------------
# kernel 1: fused bias + leaky relu and its gradient (Triton)
# ---------------------------------------------------------------------------


def fused_bias_act_plain(
    x: torch.Tensor, bias: torch.Tensor, negative_slope: float = 0.2,
    scale: float = _SQRT2,
) -> torch.Tensor:
    """``scale * leaky_relu(x + bias)`` in f32, stored in ``x.dtype``."""
    y = x.float() + bias.float()
    return (torch.where(y >= 0, y, y * negative_slope) * scale).to(x.dtype)


def fused_bias_act_grad_plain(
    g: torch.Tensor, x: torch.Tensor, bias: torch.Tensor,
    gb: torch.Tensor | None = None, negative_slope: float = 0.2,
    scale: float = _SQRT2,
) -> torch.Tensor:
    """``(x + bias >= 0 ? scale : scale * slope) * (g + gb)`` in f32, stored
    in ``g.dtype``; ``gb`` (``[C]``, default 0) runs along the last axis.
    With ``gb = 0`` this is the gradient of :func:`fused_bias_act_plain`
    with respect to ``x``; with ``gb`` the upstream gradient of the bias
    gradient it is the second-order term."""
    y = x.float() + bias.float()
    gain = torch.where(y >= 0, scale, scale * negative_slope)
    gf = g.float() if gb is None else g.float() + gb.float()
    return (gain * gf).to(g.dtype)


_BIAS_ACT_BLOCK = 1024


def _check_bias(name: str, x: torch.Tensor, bias: torch.Tensor) -> None:
    c = x.shape[-1]
    if bias.shape != (c,):
        raise ValueError(f"{name}: bias shape {tuple(bias.shape)} != ({c},)")
    if bias.device != x.device:
        raise ValueError(f"{name}: x and bias on different devices")


def _cuda_fused_bias_act(x, bias, negative_slope, scale):
    _require_cuda("fused_bias_act", x, bias)
    kernel = _triton_module("fused_bias_act").bias_act_kernel
    out = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return out
    with torch.cuda.device(x.device):
        kernel[(-(-n // _BIAS_ACT_BLOCK),)](
            x, bias.to(torch.float32).contiguous(), out, n, x.shape[-1],
            float(negative_slope), float(scale), BLOCK=_BIAS_ACT_BLOCK, num_warps=4,
        )
    fused_bias_act.launches += 1
    return out


def _cuda_fused_bias_act_grad(g, x, bias, gb, negative_slope, scale):
    _require_cuda("fused_bias_act_grad", g, x, bias)
    kernel = _triton_module("fused_bias_act").bias_act_grad_kernel
    out = torch.empty_like(g)
    n = g.numel()
    if n == 0:
        return out
    c = g.shape[-1]
    gb = torch.zeros(c, dtype=torch.float32, device=g.device) if gb is None else \
        gb.to(torch.float32).contiguous()
    with torch.cuda.device(g.device):
        kernel[(-(-n // _BIAS_ACT_BLOCK),)](
            g, gb, x, bias.to(torch.float32).contiguous(), out, n, c,
            float(scale), float(scale * negative_slope),
            BLOCK=_BIAS_ACT_BLOCK, num_warps=4,
        )
    fused_bias_act_grad.launches += 1
    return out


def _row_sum(t: torch.Tensor) -> torch.Tensor:
    """Per-channel f32 sum over every axis but the last."""
    return t.float().sum(dim=tuple(range(t.ndim - 1)))


class _FusedBiasAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bias, negative_slope, scale):
        ctx.save_for_backward(x, bias)
        ctx.args = (negative_slope, scale)
        ctx.set_materialize_grads(False)
        return _launch("fused_bias_act", x, bias, negative_slope, scale)

    @staticmethod
    def backward(ctx, dy):
        if dy is None:
            return None, None, None, None
        x, bias = ctx.saved_tensors
        dx, db = _FusedBiasActGrad.apply(contiguous_grad(dy), x, bias, None, *ctx.args)
        return dx, db.to(bias.dtype), None, None


class _FusedBiasActGrad(torch.autograd.Function):
    """``(dx, db)`` of :class:`_FusedBiasAct` given ``g`` (and ``gb``).
    Linear in ``(g, gb)`` with a mask that is constant almost everywhere, so
    its own backward is the same kernel on the upstream ``(ddx, ddb)``: one
    kernel serves every order, as StyleGAN2's
    ``FusedLeakyReLUFunctionBackward`` does."""

    @staticmethod
    def forward(ctx, g, x, bias, gb, negative_slope, scale):
        ctx.save_for_backward(x, bias)
        ctx.args = (negative_slope, scale)
        ctx.has_gb = gb is not None
        ctx.set_materialize_grads(False)
        dx = _launch("fused_bias_act_grad", g, x, bias, gb, negative_slope, scale)
        return dx, _row_sum(dx)

    @staticmethod
    def backward(ctx, ddx, ddb):
        needed = ctx.needs_input_grad[0] or ctx.needs_input_grad[3]
        if not needed or (ddx is None and ddb is None):
            return None, None, None, None, None, None
        x, bias = ctx.saved_tensors
        if ddx is None:
            ddx = torch.zeros_like(x)
        dg, dgb = _FusedBiasActGrad.apply(contiguous_grad(ddx), x, bias, ddb, *ctx.args)
        return dg, None, None, (dgb if ctx.has_gb else None), None, None


def fused_bias_act(
    x: torch.Tensor, bias: torch.Tensor, negative_slope: float = 0.2,
    scale: float = _SQRT2,
) -> torch.Tensor:
    """``scale * leaky_relu(x + bias)``; the bias runs along the last axis.

    ``x``: contiguous, channel-last (``[..., C]``), float32 or bfloat16;
    ``bias``: ``[C]``. Arithmetic in f32, result in ``x.dtype``.
    Differentiable to any order in ``x`` and ``bias``."""
    _check_device("fused_bias_act", x)
    _check_dtype("fused_bias_act", x)
    if not x.is_contiguous():
        raise ValueError("fused_bias_act: x must be contiguous with channels last")
    _check_bias("fused_bias_act", x, bias)
    if torch.compiler.is_exporting():
        return torch.ops.gan_control_torch.fused_bias_act(x, bias, negative_slope, scale)
    if _plain_path(x):
        return fused_bias_act_plain(x, bias, negative_slope, scale)
    return _FusedBiasAct.apply(x, bias, negative_slope, scale)


fused_bias_act.launches = 0


def fused_bias_act_grad(
    g: torch.Tensor, x: torch.Tensor, bias: torch.Tensor,
    gb: torch.Tensor | None = None, negative_slope: float = 0.2,
    scale: float = _SQRT2,
) -> torch.Tensor:
    """The gradient kernel of :func:`fused_bias_act` (see
    :func:`fused_bias_act_grad_plain`); ``g`` and ``x`` contiguous,
    channel-last, of one type. The autograd Functions call it; it is public
    for the tests and the kernel measurements."""
    for t in (g, x):
        _check_device("fused_bias_act_grad", t)
        _check_dtype("fused_bias_act_grad", t)
    if not (g.is_contiguous() and x.is_contiguous()) or g.shape != x.shape or g.dtype != x.dtype:
        raise ValueError("fused_bias_act_grad: g and x must be contiguous, of one shape and type")
    _check_bias("fused_bias_act_grad", x, bias)
    if gb is not None:
        _check_bias("fused_bias_act_grad", x, gb)
    if _plain_path(g):
        return fused_bias_act_grad_plain(g, x, bias, gb, negative_slope, scale)
    return _FusedBiasActGrad.apply(g, x, bias, gb, negative_slope, scale)[0]


fused_bias_act_grad.launches = 0


# ---------------------------------------------------------------------------
# kernels 2 and 3: 2x FIR upsample and downsample, adjoint to each other
# (CUDA C++)
#
# Both take per-axis correlation coefficients k0..k3 (the same on both axes):
#   up:   out[2u] = k0*x[u-1] + k2*x[u],  out[2u+1] = k1*x[u] + k3*x[u+1]
#   down: out[i]  = k0*x[2i-1] + k1*x[2i] + k2*x[2i+1] + k3*x[2i+2]
# The transpose of up with k is down with reversed(k), and the transpose of
# down with k is up with reversed(k); the gains live in the coefficients.
# ---------------------------------------------------------------------------


def _fir4(taps) -> np.ndarray:
    k = np.asarray(taps, np.float64)
    if k.shape != (4,):
        raise ValueError(f"the 2x FIR kernels take 4 taps, got {tuple(taps)}")
    return k / k.sum()


# The coefficients are computed once per tap tuple: a launch does no numpy.
@functools.cache
def _up_coefs(taps: tuple) -> tuple[float, ...]:
    """Per-axis correlation coefficients of the 2x upsample FIR: the 1-D taps
    normalised to sum 2 (gain 2 per axis, 4 in all) and reversed."""
    return tuple(float(v) for v in (_fir4(taps) * 2.0)[::-1])


@functools.cache
def _down_coefs(taps: tuple) -> tuple[float, ...]:
    """Per-axis correlation coefficients of the 2x downsample FIR (pad 1,
    true convolution with the normalised taps, stride 2)."""
    return tuple(float(v) for v in _fir4(taps)[::-1])


@functools.cache
def _reversed(k: tuple) -> tuple[float, ...]:
    return tuple(reversed(k))


def _up_plain(x: torch.Tensor, k) -> torch.Tensor:
    k0, k1, k2, k3 = k
    n, h, w, c = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))  # x[u] -> xp[u + 1]
    # per axis and phase: ((coef, start in xp), (coef, start in xp))
    pairs = (((k0, 0), (k2, 1)), ((k1, 1), (k3, 2)))
    rows = []
    for a in range(2):
        (cy0, y0), (cy1, y1) = pairs[a]
        cols = []
        for b in range(2):
            (cx0, x0), (cx1, x1) = pairs[b]
            cols.append(
                (cy0 * cx0) * xp[:, y0 : y0 + h, x0 : x0 + w]
                + (cy0 * cx1) * xp[:, y0 : y0 + h, x1 : x1 + w]
                + (cy1 * cx0) * xp[:, y1 : y1 + h, x0 : x0 + w]
                + (cy1 * cx1) * xp[:, y1 : y1 + h, x1 : x1 + w]
            )
        rows.append(torch.stack(cols, dim=3).reshape(n, h, 2 * w, c))
    return torch.stack(rows, dim=2).reshape(n, 2 * h, 2 * w, c).to(x.dtype)


def _down_plain(x: torch.Tensor, k) -> torch.Tensor:
    n, h, w, c = x.shape
    ho, wo = h // 2, w // 2
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))  # x[m] -> xp[m + 1]
    acc = None
    for i in range(4):
        for j in range(4):
            term = (k[i] * k[j]) * xp[:, i : i + 2 * ho : 2, j : j + 2 * wo : 2]
            acc = term if acc is None else acc + term
    return acc.to(x.dtype)


def blur2x_up_plain(x: torch.Tensor, taps=(1, 3, 3, 1)) -> torch.Tensor:
    """The polyphase form in PyTorch: four phase planes, each a 4-term sum
    of shifted slices of the zero-padded input, interleaved. f32 arithmetic,
    result in ``x.dtype``. Equals ``upfirdn2d.upsample_2x``."""
    return _up_plain(x, _up_coefs(tuple(taps)))


def blur2x_down_plain(x: torch.Tensor, taps=(1, 3, 3, 1)) -> torch.Tensor:
    """The 16-term sum over ``x[2u-1+i, 2v-1+j]`` in PyTorch, zero outside
    ``x``. f32 arithmetic, result in ``x.dtype``. Equals
    ``upfirdn2d.downsample_2x`` (even sizes)."""
    return _down_plain(x, _down_coefs(tuple(taps)))


# The launch path is kept short, since at the generator's small shapes the
# host's cost per launch exceeds the kernel's: the wrappers call the launcher
# directly when autograd has nothing to record, the entry point is resolved
# once per (kernel, type), the coefficients reach the C launcher as one
# pointer to a cached host array, the stream handle is read raw (the capture
# stream inside a CUDA graph), and a device context is entered only when the
# tensor is not on the current device.


def _call_on_stream(fn, args: tuple, x: torch.Tensor) -> int:
    """Calls a C entry point with ``args`` and the raw current stream of
    ``x``'s device, entering a device context only off the current device."""
    dev = x.get_device()
    if dev == torch._C._cuda_getDevice():
        return fn(*args, torch._C._cuda_getCurrentRawStream(dev))
    with torch.cuda.device(dev):
        return fn(*args, torch._C._cuda_getCurrentRawStream(dev))


@functools.cache
def _host_coefs(k: tuple) -> tuple[ctypes.Array, int]:
    """The 4 coefficients as a C float array (kept alive here) and its address."""
    arr = (ctypes.c_float * 4)(*k)
    return arr, ctypes.addressof(arr)


def _cuda_blur2x(name: str, x: torch.Tensor, k, out_hw) -> torch.Tensor:
    _require_cuda(name, x)
    n, h, w, c = x.shape
    out = x.new_empty((n, *out_hw, c))
    args = (x.data_ptr(), out.data_ptr(), n, h, w, c, _host_coefs(k)[1])
    _check_launch(name, _call_on_stream(_entry(name, x.dtype), args, x))
    return out


def _cuda_blur2x_up(x, k):
    out = _cuda_blur2x("blur2x_up", x, k, (2 * x.shape[1], 2 * x.shape[2]))
    blur2x_up.launches += 1
    return out


def _cuda_blur2x_down(x, k):
    out = _cuda_blur2x("blur2x_down", x, k, (x.shape[1] // 2, x.shape[2] // 2))
    blur2x_down.launches += 1
    return out


class _Blur2xUp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k):
        ctx.k = k
        ctx.set_materialize_grads(False)
        return _launch("blur2x_up", x, k)

    @staticmethod
    def backward(ctx, dy):
        if dy is None:
            return None, None
        return _Blur2xDown.apply(contiguous_grad(dy), _reversed(ctx.k)), None


class _Blur2xDown(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k):
        ctx.k = k
        ctx.set_materialize_grads(False)
        return _launch("blur2x_down", x, k)

    @staticmethod
    def backward(ctx, dy):
        if dy is None:
            return None, None
        return _Blur2xUp.apply(contiguous_grad(dy), _reversed(ctx.k)), None


def blur2x_up(x: torch.Tensor, taps=(1, 3, 3, 1)) -> torch.Tensor:
    """2x upsample with a separable 4-tap FIR, gain 4, NHWC in and out.

    ``x``: ``[N, H, W, C]`` contiguous, float32 or bfloat16. Returns
    ``[N, 2H, 2W, C]`` in ``x.dtype`` (f32 arithmetic). Its backward is
    ``blur2x_down`` with the coefficients reversed."""
    _check_nhwc("blur2x_up", x)
    k = _up_coefs(tuple(taps))
    if torch.compiler.is_exporting():
        return torch.ops.gan_control_torch.blur2x_up(x, k)
    if _plain_path(x):
        return _up_plain(x, k)
    if not (x.requires_grad and torch.is_grad_enabled()):
        return _launch("blur2x_up", x, k)  # autograd records nothing: the launcher alone
    return _Blur2xUp.apply(x, k)


blur2x_up.launches = 0


def blur2x_down(x: torch.Tensor, taps=(1, 3, 3, 1)) -> torch.Tensor:
    """2x downsample with a separable 4-tap FIR (pad 1, stride 2), NHWC in
    and out: ``downsample_2x(x, make_kernel(taps))``.

    ``x``: ``[N, H, W, C]`` contiguous with even ``H`` and ``W``, float32
    or bfloat16. Returns ``[N, H/2, W/2, C]`` in ``x.dtype`` (f32
    arithmetic). Its backward is ``blur2x_up`` with the coefficients
    reversed, which maps back onto the even size only."""
    _check_nhwc("blur2x_down", x)
    if x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"blur2x_down: H and W must be even, got {tuple(x.shape)}")
    k = _down_coefs(tuple(taps))
    if _plain_path(x):
        return _down_plain(x, k)
    if not (x.requires_grad and torch.is_grad_enabled()):
        return _launch("blur2x_down", x, k)  # autograd records nothing: the launcher alone
    return _Blur2xDown.apply(x, k)


blur2x_down.launches = 0


# ---------------------------------------------------------------------------
# kernel 4: stride-1 separable FIR correlation with zero pads (CUDA C++)
# ---------------------------------------------------------------------------


def _check_blur_sep_args(x: torch.Tensor, row_taps, col_taps, pad) -> tuple:
    k = len(row_taps)
    if len(col_taps) != k or not 1 <= k <= BLUR_SEP_MAX_TAPS:
        raise ValueError(f"blur_sep: 1..{BLUR_SEP_MAX_TAPS} taps per axis, the same number "
                         f"on both, got {len(row_taps)} and {len(col_taps)}")
    p0, p1 = (int(p) for p in pad)
    if not (0 <= p0 <= k - 1 and 0 <= p1 <= k - 1):
        raise ValueError(f"blur_sep: pads must lie in [0, {k - 1}], got {tuple(pad)}")
    if x.shape[1] + p0 + p1 < k or x.shape[2] + p0 + p1 < k:
        raise ValueError(f"blur_sep: input {tuple(x.shape)} smaller than the {k} taps")
    return (tuple(float(v) for v in row_taps), tuple(float(v) for v in col_taps), (p0, p1))


def blur_sep_plain(x: torch.Tensor, row_taps, col_taps, pad) -> torch.Tensor:
    """``out[u, v] = sum_ij rt[i] * ct[j] * xp[u+i, v+j]`` over the input
    zero-padded by ``pad = (p0, p1)`` on both axes: the H pass, then the W
    pass, in f32; result in ``x.dtype``."""
    p0, p1 = pad
    k = len(row_taps)
    xp = F.pad(x.float(), (0, 0, p0, p1, p0, p1))
    ho, wo = xp.shape[1] - k + 1, xp.shape[2] - k + 1
    t = None
    for i, tap in enumerate(row_taps):
        term = tap * xp[:, i : i + ho]
        t = term if t is None else t + term
    y = None
    for j, tap in enumerate(col_taps):
        term = tap * t[:, :, j : j + wo]
        y = term if y is None else y + term
    return y.to(x.dtype)


# Output rows per thread: the staged variant's bands of about 8 rows; the
# direct variant's 1 to 16 (kMaxRows in csrc/blur_sep.cu), as many as leave
# a launch BLUR_SEP_THREADS threads (about 1000 per SM of an H100).
BLUR_SEP_STAGED_ROWS = 8
BLUR_SEP_THREADS = 132 * 1024
BLUR_SEP_MAX_ROWS = 16


def blur_sep_plan(shape, k: int, pad, itemsize: int, address: int) -> tuple[int, int]:
    """``(lanes, rows)`` of a ``blur_sep`` launch on an ``[N, H, W, C]``
    input at ``address``. ``lanes``: the channels one thread owns, a 16-byte
    vector (the staged variant) or, where ``C`` is no multiple of it or the
    input is not 16-byte aligned, 1 (the direct variant). ``rows``: the
    output rows a thread walks."""
    n, h, w, c = shape
    ho, wo = h + pad[0] + pad[1] - k + 1, w + pad[0] + pad[1] - k + 1
    lanes = 16 // itemsize
    if c % lanes or address % 16:
        lanes = 1
    if lanes > 1:  # bands of equal height, about BLUR_SEP_STAGED_ROWS each
        return lanes, -(-ho // -(-ho // BLUR_SEP_STAGED_ROWS))
    units = n * ho * wo * c
    return 1, max(1, min(BLUR_SEP_MAX_ROWS, -(-units // BLUR_SEP_THREADS)))


@functools.cache
def _host_taps(row_taps: tuple, col_taps: tuple) -> tuple[ctypes.Array, int]:
    """Both tap tuples as one C float array (kept alive here), the row taps
    at ``[0, K)`` and the column taps at ``[8, 8 + K)``, and its address."""
    pad = (0.0,) * (BLUR_SEP_MAX_TAPS - len(row_taps))
    arr = (ctypes.c_float * (2 * BLUR_SEP_MAX_TAPS))(*row_taps, *pad, *col_taps, *pad)
    return arr, ctypes.addressof(arr)


def _cuda_blur_sep(x, row_taps, col_taps, pad):
    _require_cuda("blur_sep", x)
    n, h, w, c = x.shape
    k = len(row_taps)
    p0, p1 = pad
    out = x.new_empty((n, h + p0 + p1 - k + 1, w + p0 + p1 - k + 1, c))
    ptr = x.data_ptr()
    lanes, rows = blur_sep_plan(x.shape, k, pad, x.element_size(), ptr)
    args = (ptr, out.data_ptr(), n, h, w, c, k, p0, p1, lanes, rows,
            _host_taps(row_taps, col_taps)[1])
    _check_launch("blur_sep", _call_on_stream(_entry("blur_sep", x.dtype), args, x))
    blur_sep.launches += 1
    return out


class _BlurSep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, row_taps, col_taps, pad):
        ctx.args = (row_taps, col_taps, pad)
        ctx.set_materialize_grads(False)
        return _launch("blur_sep", x, row_taps, col_taps, pad)

    @staticmethod
    def backward(ctx, dy):
        if dy is None:
            return None, None, None, None
        # d corr(pad_p(x), A) / dx = corr(pad_{K-1-p}(dy), flip(A))
        rt, ct, (p0, p1) = ctx.args
        k = len(rt)
        dx = _BlurSep.apply(contiguous_grad(dy), _reversed(rt), _reversed(ct),
                            (k - 1 - p0, k - 1 - p1))
        return dx, None, None, None


def blur_sep(x: torch.Tensor, row_taps, col_taps, pad) -> torch.Tensor:
    """Separable stride-1 FIR blur on NHWC, correlation semantics (see
    :func:`blur_sep_plain`), ``K <= 8`` taps per axis and ``0 <= p <= K-1``.

    ``x``: ``[N, H, W, C]`` contiguous, float32 or bfloat16. Returns
    ``[N, H+p0+p1-K+1, W+p0+p1-K+1, C]`` in ``x.dtype`` (f32 arithmetic).
    Differentiable to any order: the backward is this kernel with the taps
    reversed and the pads ``K-1-p``."""
    _check_nhwc("blur_sep", x)
    args = _check_blur_sep_args(x, row_taps, col_taps, pad)
    if _plain_path(x):
        return blur_sep_plain(x, *args)
    if not (x.requires_grad and torch.is_grad_enabled()):
        return _launch("blur_sep", x, *args)  # autograd records nothing: the launcher alone
    return _BlurSep.apply(x, *args)


blur_sep.launches = 0


# ---------------------------------------------------------------------------
# kernel 5 (no Pallas counterpart): the battery's int8 store dequantised
# (Triton)
#
# The store (losses/int8_storage.py) is one flat int8 buffer: tensor i
# occupies ``segments[i] = (offset, length)``, both multiples of
# DEQUANT_BLOCK (the tensor's elements, then zeros to the segment's end),
# with one f32 scale ``scales[i]``; ``block_tensor[b]`` is the tensor of
# block b. The output is the same layout in f32 or bf16.
# ---------------------------------------------------------------------------

# elements per program, and the alignment of every segment of the store
DEQUANT_BLOCK = 2048


def dequant_int8_plain(q: torch.Tensor, scales: torch.Tensor, block_tensor: torch.Tensor,
                       segments, dtype: torch.dtype) -> torch.Tensor:
    """Per tensor, ``(q.float() * s).to(dtype)`` over its segment: the eager
    loop that the kernel replaces (``block_tensor`` is not read)."""
    out = torch.empty(q.shape, dtype=dtype, device=q.device)
    for i, (off, n) in enumerate(segments):
        out[off:off + n] = (q[off:off + n].float() * scales[i]).to(dtype)
    return out


def _cuda_dequant_int8(q, scales, block_tensor, segments, dtype):
    _require_cuda("dequant_int8", q, scales, block_tensor)
    out = torch.empty(q.shape, dtype=dtype, device=q.device)
    n_blocks = block_tensor.numel()
    if n_blocks == 0:
        return out
    kernel = _triton_module("dequant_int8").dequant_int8_kernel
    with torch.cuda.device(q.device):
        kernel[(n_blocks,)](q, scales, block_tensor, out, BLOCK=DEQUANT_BLOCK, num_warps=4)
    dequant_int8.launches += 1
    return out


def dequant_int8(q: torch.Tensor, scales: torch.Tensor, block_tensor: torch.Tensor, segments,
                 dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The int8 store ``q`` (1-D, contiguous, a whole number of
    ``DEQUANT_BLOCK`` blocks) dequantised into a new flat buffer of
    ``dtype`` (float32 or bfloat16): ``(q.float() * s).to(dtype)`` with the
    scale of each element's tensor, rounded to nearest even. ``scales``:
    f32 ``[T]``; ``block_tensor``: int32, the tensor of each block;
    ``segments``: each tensor's ``(offset, length)`` in elements. One launch
    on the card, no gradient."""
    for t in (q, scales, block_tensor):
        _check_device("dequant_int8", t)
    if dtype not in _DTYPES:
        raise TypeError(f"dequant_int8: output dtype {dtype} not supported (float32, bfloat16)")
    n_blocks = q.numel() // DEQUANT_BLOCK
    if (q.dtype != torch.int8 or q.ndim != 1 or not q.is_contiguous()
            or q.numel() != n_blocks * DEQUANT_BLOCK):
        raise ValueError(f"dequant_int8: q must be a contiguous 1-D int8 tensor of whole "
                         f"{DEQUANT_BLOCK}-element blocks")
    if scales.dtype != torch.float32 or scales.shape != (len(segments),) or not scales.is_contiguous():
        raise ValueError("dequant_int8: scales must be a contiguous f32 tensor, one per segment")
    if block_tensor.dtype != torch.int32 or block_tensor.shape != (n_blocks,) \
            or not block_tensor.is_contiguous():
        raise ValueError("dequant_int8: block_tensor must be a contiguous int32 tensor, one per block")
    if not (q.device == scales.device == block_tensor.device):
        raise ValueError("dequant_int8: q, scales and block_tensor on different devices")
    if _plain_path(q):
        return dequant_int8_plain(q, scales, block_tensor, segments, dtype)
    return _launch("dequant_int8", q, scales, block_tensor, segments, dtype)


dequant_int8.launches = 0


# ---------------------------------------------------------------------------
# launches and their work
# ---------------------------------------------------------------------------

# kernel -> (its launcher's name in this module, its plain version), one
# signature per pair
_LAUNCHERS = {
    "fused_bias_act": ("_cuda_fused_bias_act", fused_bias_act_plain),
    "fused_bias_act_grad": ("_cuda_fused_bias_act_grad", fused_bias_act_grad_plain),
    "blur2x_up": ("_cuda_blur2x_up", _up_plain),
    "blur2x_down": ("_cuda_blur2x_down", _down_plain),
    "blur_sep": ("_cuda_blur_sep", blur_sep_plain),
    "dequant_int8": ("_cuda_dequant_int8", dequant_int8_plain),
}


def _launch(name: str, *a):
    """The launcher of kernel ``name`` on its arguments (looked up here at
    each call, so a substituted launcher takes its place). Under a work
    accountant the launch reports :func:`kernel_work`, and a CPU tensor runs
    the plain version in the launcher's place."""
    launcher, plain = _LAUNCHERS[name]
    acc = accounting.active()
    if acc is None:
        return globals()[launcher](*a)
    x = a[0]
    with acc.kernel(name, *kernel_work(name, x.shape, x.dtype, launch_static_args(name, a))):
        return plain(*a) if x.device.type == "cpu" else globals()[launcher](*a)


def launch_static_args(name: str, a: tuple) -> tuple:
    """The arguments of a launcher call that are not tensors (for
    fused_bias_act_grad, whether it has the second-order bias term; for
    dequant_int8, the output dtype and the number of tensors)."""
    if name == "fused_bias_act":  # x, bias, slope, scale
        return (a[2], a[3])
    if name == "fused_bias_act_grad":  # g, x, bias, gb, slope, scale
        return (a[3] is not None, a[4], a[5])
    if name == "dequant_int8":  # q, scales, block_tensor, segments, dtype
        return (a[4], len(a[3]))
    return tuple(a[1:])  # blur2x_up/down: (coefficients,); blur_sep: (rt, ct, pad)


def kernel_work(name: str, shape, dtype: torch.dtype, args=()) -> tuple[int, int]:
    """``(bytes, float operations)`` of one launch on an input of ``shape``
    and ``dtype``, with the launcher's static arguments ``args``
    (:func:`launch_static_args`): each input read once and each output
    written once; the operations in f32, whatever the storage (for
    dequant_int8, ``shape`` and ``dtype`` are the int8 store's)."""
    numel = math.prod(shape)
    item = torch.tensor([], dtype=dtype).element_size()
    if name == "dequant_int8":
        # read q, the block table and the scales, write the output; one multiply each
        out_dtype, n_tensors = args
        out_item = torch.tensor([], dtype=out_dtype).element_size()
        return numel * (item + out_item) + 4 * (numel // DEQUANT_BLOCK + n_tensors), numel
    c = shape[-1]
    if name == "fused_bias_act":
        return 2 * numel * item + c * 4, 4 * numel  # add, compare-select, 2 multiplies
    if name == "fused_bias_act_grad":
        # read g and x, write dx; the bias vectors; add, compare-select, add, multiply
        return 3 * numel * item + (3 if args[0] else 2) * c * 4, 4 * numel
    if name == "blur2x_up":
        return 5 * numel * item, 8 * 4 * numel  # 4x the input out, 4 MACs each
    if name == "blur2x_down":
        return numel * item * 5 // 4, 2 * 16 * numel // 4  # 16 MACs per output
    # blur_sep: K MACs per H-pass element ((H_out x W) of them), K per output
    rt, _, (p0, p1) = args
    k = len(rt)
    n, h, w, _ = shape
    ho, wo = h + p0 + p1 - k + 1, w + p0 + p1 - k + 1
    nbytes = (numel + n * ho * wo * c) * item
    return nbytes, 2 * k * n * ho * (w + p0 + p1) * c + 2 * k * n * ho * wo * c


# ---------------------------------------------------------------------------
# the export route of the generation path's two kernels (custom ops)
#
# torch.export traces neither the ctypes launchers nor the Triton launch, so
# while a program is being exported (torch.compiler.is_exporting()) the
# fused_bias_act and blur2x_up wrappers call these ops instead, and the
# exported graph holds them as nodes. Each op runs the launcher on CUDA
# tensors (the kernel or an error, as the wrapper's own path) and the plain
# version on CPU tensors; its fake implementation gives the output's shape
# and type to the tracer. Importing this module registers them, which is all
# that a program loaded with torch.export.load needs of the port.
# ---------------------------------------------------------------------------


@torch.library.custom_op("gan_control_torch::fused_bias_act", mutates_args=(), device_types="cpu")
def _fused_bias_act_op(x: torch.Tensor, bias: torch.Tensor, negative_slope: float,
                       scale: float) -> torch.Tensor:
    return fused_bias_act_plain(x, bias, negative_slope, scale)


@_fused_bias_act_op.register_kernel("cuda")
def _(x, bias, negative_slope, scale):
    return _cuda_fused_bias_act(x, bias, negative_slope, scale)


@_fused_bias_act_op.register_fake
def _(x, bias, negative_slope, scale):
    return torch.empty_like(x)


@torch.library.custom_op("gan_control_torch::blur2x_up", mutates_args=(), device_types="cpu")
def _blur2x_up_op(x: torch.Tensor, coefs: list[float]) -> torch.Tensor:
    return _up_plain(x, tuple(coefs))


@_blur2x_up_op.register_kernel("cuda")
def _(x, coefs):
    return _cuda_blur2x_up(x, tuple(coefs))


@_blur2x_up_op.register_fake
def _(x, coefs):
    n, h, w, c = x.shape
    return x.new_empty((n, 2 * h, 2 * w, c))


# ---------------------------------------------------------------------------
# counters
# ---------------------------------------------------------------------------

KERNELS = (fused_bias_act, fused_bias_act_grad, blur2x_up, blur2x_down, blur_sep, dequant_int8)


def launch_counts() -> dict[str, int]:
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
    contiguous_grad.copies = 0
