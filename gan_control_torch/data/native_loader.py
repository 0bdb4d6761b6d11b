"""ctypes binding of the native C++ data loader (``native/gcdata.cpp``): a
C++ thread pool that decodes JPEG/PNG, crops, resizes (half-pixel bilinear
sampling, as ``F.interpolate``; the Python loader's PIL BILINEAR
antialiases on downscale, so pick one backend per run), flips and maps to
[-1, 1], handing NHWC float32 batches over.

The library is built at first use with ``g++`` and ``native/Makefile``'s
flags into ``build/gan_control_torch/`` of the checkout, under a name that
carries a hash of the source; ``native/`` itself is never written. Where it
cannot be built (no compiler, no libjpeg/libpng headers) or loaded, or its
ABI is older than this binding knows, :func:`available` is False and the
reason is logged once.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Iterator, Sequence

import numpy as np

from gan_control_torch.utils.logging_utils import get_logger

_log = get_logger(__name__)

# 3: per-batch failed counts through gc_loader_next2
_MIN_ABI = 3
_REPO = Path(__file__).resolve().parents[2]
_SOURCE = _REPO / "native" / "gcdata.cpp"
BUILD_DIR = _REPO / "build" / "gan_control_torch"
# native/Makefile: CXXFLAGS and LDFLAGS
_CXXFLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall"]
_LDFLAGS = ["-shared", "-ljpeg", "-lpng", "-lpthread"]


def _lib_path() -> Path:
    digest = hashlib.sha256(_SOURCE.read_bytes() + " ".join(_CXXFLAGS + _LDFLAGS).encode())
    return BUILD_DIR / f"libgcdata_{digest.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile ``native/gcdata.cpp`` unless built already; returns the
    library's path. Raises with the compiler's output if it fails."""
    out = _lib_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no C++ compiler (g++) to build native/gcdata.cpp")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *_CXXFLAGS, str(_SOURCE), "-o", str(tmp), *_LDFLAGS],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on native/gcdata.cpp:\n{proc.stderr.strip()}")
    os.replace(tmp, out)
    return out


@functools.cache
def load_library() -> ctypes.CDLL | None:
    """The built library with its signatures declared, or None (the reason
    logged once)."""
    try:
        lib = ctypes.CDLL(str(build()))
    except (RuntimeError, OSError) as e:
        _log.warning("native data loader unavailable, using the Python loader: %s", e)
        return None
    lib.gc_abi_version.restype = ctypes.c_long
    lib.gc_abi_version.argtypes = []
    if lib.gc_abi_version() < _MIN_ABI:
        _log.warning("native data loader has ABI %d < %d, using the Python loader",
                     lib.gc_abi_version(), _MIN_ABI)
        return None
    lib.gc_loader_failed_slots.restype = ctypes.c_long
    lib.gc_loader_failed_slots.argtypes = [ctypes.c_void_p]
    lib.gc_loader_create.restype = ctypes.c_void_p
    lib.gc_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_uint64, ctypes.c_int, ctypes.c_float,
    ]
    lib.gc_loader_next2.restype = ctypes.c_int
    lib.gc_loader_next2.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                                    ctypes.POINTER(ctypes.c_long)]
    lib.gc_loader_destroy.restype = None
    lib.gc_loader_destroy.argtypes = [ctypes.c_void_p]
    lib.gc_decode_one.restype = ctypes.c_int
    lib.gc_decode_one.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_float)]
    return lib


def available() -> bool:
    return load_library() is not None


def _require() -> ctypes.CDLL:
    lib = load_library()
    if lib is None:
        raise RuntimeError("the native data loader could not be built or loaded (see the log)")
    return lib


def _float_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def decode_one(path: str | Path, size: int) -> np.ndarray:
    """One JPEG/PNG decoded and resized to [size, size, 3] float32 in [-1, 1]."""
    out = np.empty((size, size, 3), np.float32)
    if _require().gc_decode_one(str(path).encode(), size, _float_ptr(out)) != 0:
        raise IOError(f"decode failed: {path}")
    return out


def native_loader(paths: Sequence[str | Path], size: int, batch_size: int, workers: int = 4,
                  seed: int = 0, hflip: bool = True,
                  random_resized_crop_p: float = 0.0) -> Iterator[np.ndarray]:
    """Infinite NHWC float32 [-1, 1] batches from the C++ pipeline. Each
    worker thread fills whole batches, so the order of batches is
    reproducible from ``seed`` with one worker only. A batch whose every
    slot failed to decode raises; a partly failed one (zero-filled slots)
    warns."""
    lib = _require()
    enc = [str(p).encode() for p in paths]
    arr = (ctypes.c_char_p * len(enc))(*enc)
    handle = lib.gc_loader_create(arr, len(enc), size, batch_size, workers, seed, int(hflip),
                                  float(random_resized_crop_p))
    if not handle:
        raise RuntimeError("gc_loader_create failed")
    try:
        while True:
            out = np.empty((batch_size, size, size, 3), np.float32)
            failed = ctypes.c_long(0)
            if lib.gc_loader_next2(handle, _float_ptr(out), ctypes.byref(failed)) != 0:
                return
            if failed.value >= batch_size:
                raise RuntimeError(f"native loader: all {batch_size} image slots of a batch failed "
                                   "to decode; refusing to train on zero-filled batches")
            if failed.value > 0:
                _log.warning("native loader: %d/%d image slot(s) of this batch failed to decode "
                             "and were zero-filled (%d in all)", failed.value, batch_size,
                             int(lib.gc_loader_failed_slots(handle)))
            yield out
    finally:
        lib.gc_loader_destroy(handle)
