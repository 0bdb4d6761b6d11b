"""The Hopper kernels of the controlled-generation path, their plain
PyTorch versions, builds and launch counters.

Two TPU kernels of ``gan_control_tpu/ops/pallas_kernels.py`` run on this
path, and each has a kernel written for the H100 here:

  - ``fused_bias_act`` (Pallas ``fused_bias_act``, :86): Triton, source in
    ``csrc/fused_bias_act.py``. Bound by device-memory bytes; see the source.
  - ``blur2x_up`` (Pallas ``blur2x_up``, :215): CUDA C++ for ``sm_90a``,
    source in ``csrc/blur2x_up.cu``, built with ``nvcc`` into a shared library
    with a plain C interface and bound through ``ctypes``. Bound by
    device-memory bytes; see the source.

Each wrapper takes its plain version only for a tensor on the CPU. For a
CUDA tensor it launches the kernel or raises; there is no fallback. Each
wrapper checks the layout it takes (the channel is the innermost physical
axis: NHWC or ``[rows, C]``, contiguous) and raises on any other, on every
device. ``<wrapper>.launches`` counts kernel launches and nothing else.

The CUDA library is built at first use (or by :func:`build`) into
``build/gan_control_torch/`` of the checkout, under a name that carries a
hash of its source, so a changed source is never served by a stale build.
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

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "gan_control_torch"
_SQRT2 = math.sqrt(2.0)
_DTYPES = (torch.float32, torch.bfloat16)

# CUDA sources built into one shared library each
_CUDA_SOURCES = {"blur2x_up": "blur2x_up.cu"}
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _check_dtype(name: str, x: torch.Tensor) -> None:
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {x.dtype} not supported (float32, bfloat16)")


def _check_device(name: str, x: torch.Tensor) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"{name}: tensors on {x.device} are not supported")


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
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        os.replace(tmp, out)
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
    return report


@functools.cache
def _cuda_lib(name: str) -> ctypes.CDLL:
    build([name])
    lib = ctypes.CDLL(str(_lib_path(name)))
    if name == "blur2x_up":
        args = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 4 + \
               [ctypes.c_float] * 4 + [ctypes.c_void_p]
        for fn in (lib.blur2x_up_f32, lib.blur2x_up_bf16):
            fn.argtypes = args
            fn.restype = ctypes.c_int
    return lib


@functools.cache
def _triton_module(name: str):
    """Load a Triton kernel source from ``csrc/`` (imports ``triton``)."""
    spec = importlib.util.spec_from_file_location(
        f"gan_control_torch_csrc_{name}", _CSRC / f"{name}.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# kernel 1: fused bias + leaky relu (Triton)
# ---------------------------------------------------------------------------


def fused_bias_act_plain(
    x: torch.Tensor, bias: torch.Tensor, negative_slope: float = 0.2,
    scale: float = _SQRT2,
) -> torch.Tensor:
    """``scale * leaky_relu(x + bias)`` in f32, stored in ``x.dtype``."""
    y = x.float() + bias.float()
    return (torch.where(y >= 0, y, y * negative_slope) * scale).to(x.dtype)


_BIAS_ACT_BLOCK = 1024


def fused_bias_act(
    x: torch.Tensor, bias: torch.Tensor, negative_slope: float = 0.2,
    scale: float = _SQRT2,
) -> torch.Tensor:
    """``scale * leaky_relu(x + bias)``; the bias runs along the last axis.

    ``x``: contiguous, channel-last (``[..., C]``), float32 or bfloat16;
    ``bias``: ``[C]``. Arithmetic in f32, result in ``x.dtype``."""
    _check_device("fused_bias_act", x)
    _check_dtype("fused_bias_act", x)
    c = x.shape[-1]
    if not x.is_contiguous():
        raise ValueError("fused_bias_act: x must be contiguous with channels last")
    if bias.shape != (c,):
        raise ValueError(f"fused_bias_act: bias shape {tuple(bias.shape)} != ({c},)")
    if bias.device != x.device:
        raise ValueError("fused_bias_act: x and bias on different devices")
    if x.device.type == "cpu":
        return fused_bias_act_plain(x, bias, negative_slope, scale)
    kernel = _triton_module("fused_bias_act").bias_act_kernel
    out = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return out
    grid = (-(-n // _BIAS_ACT_BLOCK),)
    with torch.cuda.device(x.device):
        kernel[grid](
            x, bias.to(torch.float32).contiguous(), out, n, c,
            float(negative_slope), float(scale), BLOCK=_BIAS_ACT_BLOCK,
            num_warps=4,
        )
    fused_bias_act.launches += 1
    return out


fused_bias_act.launches = 0


# ---------------------------------------------------------------------------
# kernel 2: 2x FIR upsample, polyphase, interleaved output (CUDA C++)
# ---------------------------------------------------------------------------


def _axis_taps(taps) -> tuple[float, float, float, float]:
    """Per-axis correlation taps (k0..k3) of the 2x upsample FIR: the 1-D
    taps normalised to sum 2 (gain 2 per axis, 4 in all) and reversed."""
    k = np.asarray(taps, np.float64)
    if k.shape != (4,):
        raise ValueError(f"blur2x_up takes 4 taps, got {tuple(taps)}")
    k = k / k.sum() * 2.0
    return tuple(float(v) for v in k[::-1])


def blur2x_up_plain(x: torch.Tensor, taps=(1, 3, 3, 1)) -> torch.Tensor:
    """The polyphase form in PyTorch: four phase planes, each a 4-term sum
    of shifted slices of the zero-padded input, interleaved. f32 arithmetic,
    result in ``x.dtype``. Equals ``upfirdn2d.upsample_2x``."""
    k0, k1, k2, k3 = _axis_taps(taps)
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


def blur2x_up(x: torch.Tensor, taps=(1, 3, 3, 1)) -> torch.Tensor:
    """2x upsample with a separable 4-tap FIR, gain 4, NHWC in and out.

    ``x``: ``[N, H, W, C]`` contiguous, float32 or bfloat16. Returns
    ``[N, 2H, 2W, C]`` in ``x.dtype`` (f32 arithmetic)."""
    _check_device("blur2x_up", x)
    _check_dtype("blur2x_up", x)
    if x.ndim != 4 or not x.is_contiguous():
        raise ValueError("blur2x_up: x must be a contiguous NHWC tensor")
    k = _axis_taps(taps)
    if x.device.type == "cpu":
        return blur2x_up_plain(x, taps)
    n, h, w, c = x.shape
    out =torch.empty((n, 2 * h, 2 * w, c), dtype=x.dtype, device=x.device)
    lib = _cuda_lib("blur2x_up")
    fn = lib.blur2x_up_f32 if x.dtype == torch.float32 else lib.blur2x_up_bf16
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), n, h, w, c, *k, stream)
    if err != 0:
        raise RuntimeError(f"blur2x_up: kernel launch failed with CUDA error {err}")
    blur2x_up.launches += 1
    return out


blur2x_up.launches = 0


# ---------------------------------------------------------------------------
# counters
# ---------------------------------------------------------------------------

KERNELS = (fused_bias_act, blur2x_up)


def launch_counts() -> dict[str, int]:
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
