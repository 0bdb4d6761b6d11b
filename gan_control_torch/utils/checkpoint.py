"""Checkpoints in the JAX package's format, read and written without flax.

The JAX package saves ``<dir>/checkpoint/%06d.ckpt`` as flax msgpack
(``flax.serialization.msgpack_serialize`` of the state dict). The machine
that runs the port has neither flax nor the ``msgpack`` package, so this
module carries a small pure-Python reader and writer of that format:

  - msgpack maps, str, bin, arrays, ints, floats, nil and bool;
  - ext type 1: an ndarray, itself a msgpack array ``(shape, dtype name,
    C-order bytes)``;
  - ext type 3: a numpy scalar in the same encoding.

Anything else raises, including flax's chunked leaves
(``__msgpack_chunked_array__``), which flax writes only for a leaf over
2**30 bytes; no array of this ~30M-parameter model comes near that.
A ``bfloat16`` leaf (numpy has no such type) is widened exactly to float32.

Periodic saves can overlap training: :func:`save_checkpoint_async` takes a
tree that is already on the host, and one worker thread encodes and writes
it (in order); :func:`wait_pending_saves` drains the queue and raises the
first failure.
"""

from __future__ import annotations

import concurrent.futures
import os
import re
import struct
import threading
from pathlib import Path
from typing import Any

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_CHUNKED_KEY = "__msgpack_chunked_array__"


# ---------------------------------------------------------------------------
# directory contract
# ---------------------------------------------------------------------------


def latest_checkpoint(ckpt_dir: str | Path) -> Path | None:
    """Lexicographically-last ``*.ckpt`` (zero-padded steps; ``best_fid``
    sorts after digits and wins when present)."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.is_dir():
        return None
    files = sorted(p for p in ckpt_dir.iterdir() if p.suffix == ".ckpt")
    return files[-1] if files else None


def parse_step(path: str | Path, default: int = 0) -> int:
    """The training step that a checkpoint's file name encodes; ``default``
    for a non-numeric name (``best_fid.ckpt``), where a resume keeps the
    configured ``start_iter``."""
    m = re.match(r"(\d+)", Path(path).stem)
    return int(m.group(1)) if m else default


def load_state_dict(path: str | Path) -> dict:
    """Nested dict of numpy arrays stored in a flax msgpack checkpoint."""
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


def save_checkpoint(ckpt_dir: str | Path, state: dict, step: int,
                    name: str | None = None) -> Path:
    """Write ``state`` (nested dicts of numpy arrays) to
    ``ckpt_dir/%06d.ckpt`` (or ``<name>.ckpt``), atomically by rename."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    fname = f"{name}.ckpt" if name else f"{step:06d}.ckpt"
    path = ckpt_dir / fname
    tmp = ckpt_dir / (fname + ".tmp")
    with open(tmp, "wb") as f:
        f.write(msgpack_serialize(state))
    os.replace(tmp, path)
    return path


_SAVE_LOCK = threading.Lock()
_SAVE_POOL: concurrent.futures.ThreadPoolExecutor | None = None  # one worker: saves stay ordered
_PENDING: list[concurrent.futures.Future] = []


def save_checkpoint_async(ckpt_dir: str | Path, state: dict, step: int,
                          name: str | None = None) -> concurrent.futures.Future:
    """:func:`save_checkpoint` on a background worker. ``state`` must be
    host memory that training will not change (numpy copies). Returns a
    future of the written path; call :func:`wait_pending_saves` before the
    process exits."""
    global _SAVE_POOL
    with _SAVE_LOCK:
        if _SAVE_POOL is None:
            _SAVE_POOL = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="ckpt-save")
        fut = _SAVE_POOL.submit(save_checkpoint, ckpt_dir, state, step, name)
        _PENDING.append(fut)
    return fut


def wait_pending_saves() -> None:
    """Wait for every queued save and raise the first failure: a run whose
    periodic checkpoints failed must not end as if they had been written."""
    global _SAVE_POOL
    with _SAVE_LOCK:
        pool, _SAVE_POOL = _SAVE_POOL, None
        pending, _PENDING[:] = list(_PENDING), []
    if pool is not None:
        pool.shutdown(wait=True)
    for fut in pending:
        exc = fut.exception()
        if exc is not None:
            raise exc


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------


def _dtype_from_name(name: str) -> np.dtype:
    if name == "bfloat16":
        return np.dtype(np.uint16)  # widened to float32 by the caller
    return np.dtype(name)


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    tpl = _Reader(data).read_all()
    if not (isinstance(tpl, list) and len(tpl) == 3):
        raise ValueError("malformed ndarray payload in msgpack checkpoint")
    shape, dtype_name, buf = tpl
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    arr = np.frombuffer(buf, dtype=_dtype_from_name(dtype_name)).reshape(shape)
    if dtype_name == "bfloat16":
        arr = (arr.astype(np.uint32) << 16).view(np.float32)
    return arr


class _Reader:
    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0

    def read_all(self) -> Any:
        obj = self.read()
        if self.pos != len(self.buf):
            raise ValueError("trailing bytes after msgpack object")
        return obj

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self._take(size))[0]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        if _CHUNKED_KEY in out:
            raise ValueError(
                "chunked array leaf in checkpoint (a leaf over flax's "
                "MAX_CHUNK_SIZE); not supported"
            )
        return out

    def _ext(self, n: int):
        code = self._unpack(">b")
        data = bytes(self._take(n))
        if code == _EXT_NDARRAY:
            return _ndarray_from_bytes(data)
        if code == _EXT_NPSCALAR:
            return _ndarray_from_bytes(data)[()]
        raise ValueError(f"unsupported msgpack ext type {code}")

    def read(self) -> Any:
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self._take(b & 0x1F), "utf-8")
        simple = {
            0xC0: lambda: None,
            0xC2: lambda: False,
            0xC3: lambda: True,
            0xC4: lambda: bytes(self._take(self._unpack(">B"))),
            0xC5: lambda: bytes(self._take(self._unpack(">H"))),
            0xC6: lambda: bytes(self._take(self._unpack(">I"))),
            0xC7: lambda: self._ext(self._unpack(">B")),
            0xC8: lambda: self._ext(self._unpack(">H")),
            0xC9: lambda: self._ext(self._unpack(">I")),
            0xCA: lambda: self._unpack(">f"),
            0xCB: lambda: self._unpack(">d"),
            0xCC: lambda: self._unpack(">B"),
            0xCD: lambda: self._unpack(">H"),
            0xCE: lambda: self._unpack(">I"),
            0xCF: lambda: self._unpack(">Q"),
            0xD0: lambda: self._unpack(">b"),
            0xD1: lambda: self._unpack(">h"),
            0xD2: lambda: self._unpack(">i"),
            0xD3: lambda: self._unpack(">q"),
            0xD4: lambda: self._ext(1),
            0xD5: lambda: self._ext(2),
            0xD6: lambda: self._ext(4),
            0xD7: lambda: self._ext(8),
            0xD8: lambda: self._ext(16),
            0xD9: lambda: str(self._take(self._unpack(">B")), "utf-8"),
            0xDA: lambda: str(self._take(self._unpack(">H")), "utf-8"),
            0xDB: lambda: str(self._take(self._unpack(">I")), "utf-8"),
            0xDC: lambda: [self.read() for _ in range(self._unpack(">H"))],
            0xDD: lambda: [self.read() for _ in range(self._unpack(">I"))],
            0xDE: lambda: self._map(self._unpack(">H")),
            0xDF: lambda: self._map(self._unpack(">I")),
        }
        if b not in simple:
            raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")
        return simple[b]()


def msgpack_restore(data: bytes) -> Any:
    """Decode flax-msgpack bytes into nested dicts of numpy arrays."""
    return _Reader(data).read_all()


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------


def _pack_len(out: list, n: int, fix_base: int | None, fix_max: int,
              codes: tuple[int, int, int]) -> None:
    if fix_base is not None and n <= fix_max:
        out.append(struct.pack(">B", fix_base | n))
    elif n <= 0xFF and codes[0] is not None:
        out.append(struct.pack(">BB", codes[0], n))
    elif n <= 0xFFFF:
        out.append(struct.pack(">BH", codes[1], n))
    elif n <= 0xFFFFFFFF:
        out.append(struct.pack(">BI", codes[2], n))
    else:
        raise ValueError("msgpack object too large")


def _pack_int(out: list, v: int) -> None:
    if 0 <= v <= 0x7F:
        out.append(struct.pack(">B", v))
    elif -32 <= v < 0:
        out.append(struct.pack(">b", v))
    elif 0 <= v <= 0xFFFFFFFF:
        out.append(struct.pack(">BI", 0xCE, v))
    elif 0 <= v <= 0xFFFFFFFFFFFFFFFF:
        out.append(struct.pack(">BQ", 0xCF, v))
    elif -(2**63) <= v < 0:
        out.append(struct.pack(">Bq", 0xD3, v))
    else:
        raise ValueError(f"int {v} does not fit msgpack")


def _ndarray_to_bytes(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.fields is not None:
        raise ValueError("object and structured dtypes cannot be serialized")
    return msgpack_serialize([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def _pack_ext(out: list, code: int, data: bytes) -> None:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(struct.pack(">Bb", fixed[n], code))
    elif n <= 0xFF:
        out.append(struct.pack(">BBb", 0xC7, n, code))
    elif n <= 0xFFFF:
        out.append(struct.pack(">BHb", 0xC8, n, code))
    else:
        out.append(struct.pack(">BIb", 0xC9, n, code))
    out.append(data)


def _pack(out: list, obj: Any) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif isinstance(obj, np.ndarray):
        _pack_ext(out, _EXT_NDARRAY, _ndarray_to_bytes(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _ndarray_to_bytes(np.asarray(obj)))
    elif isinstance(obj, bool):
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(out, len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray)):
        _pack_len(out, len(obj), None, -1, (0xC4, 0xC5, 0xC6))
        out.append(bytes(obj))
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 15, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(obj, list):
        _pack_len(out, len(obj), 0x90, 15, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(out, v)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__} to msgpack")


def msgpack_serialize(tree: Any) -> bytes:
    """Encode nested dicts of numpy arrays as flax msgpack bytes, readable
    by ``flax.serialization.msgpack_restore``."""
    out: list = []
    _pack(out, tree)
    return b"".join(out)
