"""Tuning sweep of the blur_sep kernel on one H100.

    python3 gan_control_torch/tools/blur_sep_sweep.py

Run from the root of a checkout on a machine with the card and ``nvcc``.
Variants of ``gan_control_torch/csrc/blur_sep.cu`` are made from the source
by text substitution (each asserted to apply), built side by side under
``build/blur_sep_sweep/`` and timed at the 28 shapes the FFHQ-512
discriminator gives the kernel at batch 16 in bf16 (per level (s, C): the
conv2 and skip pre-blurs, pads (2, 2) and (1, 1), and their backwards):

  shipped        the source as it is (the staged variant, TMA row copies)
  direct_vec     the direct variant with 16-byte vector lanes in the staged
                 one's place: each thread loads its taps from device memory
  direct_vec_u2  the same with its row loop unrolled twice
  stages4        4 shared-memory buffers per block instead of 8
  chunk256       tiles of 256 bytes of channels instead of 128

each at bands of about 4, 8 (what ``kernels.blur_sep_plan`` picks) and 16
output rows. Every variant is checked against ``blur_sep_plain`` at every
shape. A plain device copy of as many bytes as the input (``Tensor.copy_``)
is timed beside them as a yardstick of the card's copy rate. Times are
device times as in ``chip_smoke.py``: calls captured in a CUDA graph and
replayed, the variants timed in one order and then in the reverse one.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from gan_control_torch.ops import kernels  # noqa: E402

SOURCE = REPO / "gan_control_torch" / "csrc" / "blur_sep.cu"
OUT = REPO / "build" / "blur_sep_sweep"
BLUR4 = (0.125, 0.375, 0.375, 0.125)
LEVELS = [(512, 64), (256, 128), (128, 256), (64, 512), (32, 512), (16, 512), (8, 512)]
ROWS = (4, 8, 16)
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
STAGED_CALL = "return launch_staged<T>("
DIRECT_VEC_CALL = "return launch_direct<T, 16 / sizeof(T)>("
ROW_LOOP = "#pragma unroll 1\n  for (; u < ua; ++u)"
# name -> substitutions (old, new) applied to the source
VARIANTS = {
    "shipped": [],
    "direct_vec": [(STAGED_CALL, DIRECT_VEC_CALL)],
    "direct_vec_u2": [(STAGED_CALL, DIRECT_VEC_CALL),
                      (ROW_LOOP, ROW_LOOP.replace("unroll 1", "unroll 2"))],
    "stages4": [("constexpr int kStages = 8;", "constexpr int kStages = 4;")],
    "chunk256": [("constexpr int kChunkBytes = 128;", "constexpr int kChunkBytes = 256;")],
}


def build() -> dict:
    """Compiles every variant (one nvcc each, all at once); returns its
    bf16 entry point by name."""
    OUT.mkdir(parents=True, exist_ok=True)
    src = SOURCE.read_text()
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: {old!r} is not in the source once")
            text = text.replace(old, new)
        cu = OUT / f"{name}.cu"
        cu.write_text(text)
        cmd = [kernels._nvcc(), *kernels._NVCC_FLAGS, "-o", str(OUT / f"lib{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    entries = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        regs = [ln.split(": ", 1)[-1].strip() for ln in log.splitlines() if "Used" in ln]
        print(f"build {name}: " + " | ".join(regs), flush=True)
        fn = ctypes.CDLL(str(OUT / f"lib{name}.so")).blur_sep_bf16
        fn.argtypes = kernels._C_SIGNATURES["blur_sep"]
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


def device_us(fn, calls: int = 20, replays: int = 3) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * calls) * 1e3


def path_shapes():
    for s, c in LEVELS:
        for shape, pad in (((16, s, s, c), (2, 2)), ((16, s, s, c), (1, 1)),
                           ((16, s + 1, s + 1, c), (1, 1)), ((16, s - 1, s - 1, c), (2, 2))):
            yield (s, c), shape, pad


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("blur_sep_sweep: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    entries = build()
    taps = kernels._host_taps(BLUR4, BLUR4)[1]
    gen = torch.Generator(device="cuda").manual_seed(0)
    totals: dict[str, float] = {}
    by_level: dict[tuple, dict[str, float]] = {}
    bounds: dict[tuple, float] = {}
    failed = []
    for level, shape, pad in path_shapes():
        n, h, w, c = shape
        ho, wo = h + pad[0] + pad[1] - 3, w + pad[0] + pad[1] - 3
        x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        out = torch.empty((n, ho, wo, c), device="cuda", dtype=torch.bfloat16)
        want = kernels.blur_sep_plain(x, BLUR4, BLUR4, pad).float()
        tol = 2.0**-7 * max(1.0, float(want.abs().max()))
        bound = (x.numel() + out.numel()) * 2 / PEAK_BYTES_PER_S * 1e6
        bounds[level] = bounds.get(level, 0.0) + bound
        cases = {}
        for name, fn in entries.items():
            for target in ROWS:
                rows = -(-ho // -(-ho // target))

                def call(fn=fn, rows=rows):
                    err = fn(x.data_ptr(), out.data_ptr(), n, h, w, c, 4, pad[0], pad[1], 8, rows,
                             taps, torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"launch failed with CUDA error {err}")

                cases[f"{name}/r{target}"] = call
        m = min(x.numel(), out.numel())
        cases["copy"] = lambda: out.view(-1)[:m].copy_(x.view(-1)[:m])
        for name, call in cases.items():
            if name == "copy":
                continue
            out.fill_(float("nan"))
            call()
            err = float((out.float() - want).abs().max())
            if not err <= tol:
                failed.append(f"{name} {shape} {pad}: {err} > {tol}")
        times = {name: 0.0 for name in cases}
        order = list(cases)
        for names in (order, order[::-1]):
            for name in names:
                times[name] += device_us(cases[name]) / 2
        print(f"{list(shape)} pad {pad} bound {bound:.2f} us: "
              + " ".join(f"{k} {v:.2f}" for k, v in times.items()), flush=True)
        for name, t in times.items():
            totals[name] = totals.get(name, 0.0) + t
            by_level.setdefault(level, {})
            by_level[level][name] = by_level[level].get(name, 0.0) + t
        del x, out, want
    for level, times in by_level.items():
        print(f"level {level[0]} px C {level[1]} (one launch of each of 4 shapes, us): bound "
              f"{bounds[level]:.2f}; " + " ".join(f"{k} {v:.2f}" for k, v in times.items()), flush=True)
    print("total over the 28 shapes (us), fastest first: "
          + ", ".join(f"{k} {v:.2f}" for k, v in sorted(totals.items(), key=lambda kv: kv[1])), flush=True)
    if failed:
        raise SystemExit("disagree with the plain version:\n" + "\n".join(failed))


if __name__ == "__main__":
    main()
