"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card (an H100:
the CUDA kernel is built for sm_90a). It exits non-zero, printing no
result, when there is no card or when the checkout's files are missing.

Phases (none is caught; any failure exits non-zero):

 1. the card's name and power limit, as nvidia-smi reports them;
 2. build the CUDA kernel library (nvcc) and compile the Triton kernel;
 3. write an FFHQ-512 controller directory (configs/ffhq.json, the
    orientation and age heads) at random init in the JAX package's layout,
    with the port's own msgpack writer, and load it through ``Controller``;
 4. kernels: at every (shape, dtype) the main path gives each kernel
    (recorded by module hooks in one warm-up call), in f32 with TF32 off and
    in bf16, hold the kernel against its plain PyTorch version, and time the
    kernel, the plain version and, for blur2x_up, one PyTorch call that
    computes the same function (a depthwise ``conv_transpose2d``);
 5. main path: one ``gen_batch_by_controls(batch_size=8, orientation=...,
    age=...)`` in the config's bf16 synthesis, with the kernel launch
    counters set to 0 just before and read just after; then the median of a
    few warm calls, and the device time by kernel of one more (profiler);
 6. card against CPU: the same directory at batch 1 in f32 with TF32 off,
    the card's kernels against the port's plain CPU path on the same latent
    and noise;
 7. one JSON line of per-kernel numbers, then the result line.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parent
CONFIGS = REPO / "gan_control_tpu" / "configs"
BATCH = 8
# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, f32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
REPLACES = {
    "fused_bias_act": "gan_control_tpu/ops/pallas_kernels.py:86",
    "blur2x_up": "gan_control_tpu/ops/pallas_kernels.py:215",
}
SOURCES = {
    "fused_bias_act": ("triton", "gan_control_torch/csrc/fused_bias_act.py"),
    "blur2x_up": ("cuda", "gan_control_torch/csrc/blur2x_up.cu"),
}
# kernel vs plain version, relative to max|plain|: f32 is the same f32
# arithmetic in another order; bf16 may round across one bf16 step (2**-7)
KERNEL_RTOL = {torch.float32: 1e-6, torch.bfloat16: 2.0**-7}
# card vs CPU through the whole f32 generator: cuDNN and the CPU convs sum in
# other orders over up to 4608 terms per output, 16 layers deep
PARITY_RTOL = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    sys.exit(2)


def cuda_ms(fn, min_total_ms: float = 50.0) -> float:
    """Mean device time of ``fn`` over back-to-back launches (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    iters = int(min(1000, max(5, min_total_ms / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(name: str, shape, dtype) -> tuple[float, str]:
    """Least time (ms) for one call: bytes (each input read once, each output
    written once) over peak bandwidth vs operations over the f32 peak."""
    numel = int(np.prod(shape))
    item = torch.tensor([], dtype=dtype).element_size()
    if name == "fused_bias_act":
        nbytes = 2 * numel * item + shape[-1] * 4
        ops = 4 * numel  # add, compare-select, two multiplies
    else:
        nbytes = 5 * numel * item  # read x, write 4x
        ops = 8 * 4 * numel  # 4 multiply-adds per output element
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def write_controller_dir(root: Path) -> None:
    """FFHQ-512 generator + orientation and age heads at random init (the
    JAX initialisers' distributions), in the JAX package's layout."""
    from gan_control_torch.models.blocks import init_params_
    from gan_control_torch.models.controller import FcStack
    from gan_control_torch.models.factory import build_generator, build_group_spec
    from gan_control_torch.utils.flax_bridge import save_flax_checkpoint

    config = json.loads((CONFIGS / "ffhq.json").read_text())
    gdir = root / "generator"
    gdir.mkdir(parents=True)
    (gdir / "args.json").write_text(json.dumps(config, indent=2))
    spec = build_group_spec(config)
    gen = build_generator(config, spec, device="cpu", seed=0)
    save_flax_checkpoint(gdir / "checkpoint", "g_ema", gen)
    for i, group in enumerate(("orientation", "age")):
        hcfg = json.loads((CONFIGS / "controller_configs" / "ffhq" / f"{group}_controller.json").read_text())
        mc = hcfg["model_config"]
        head = FcStack(in_dim=mc["in_dim"], n_mlp=mc["n_mlp"], mid_dim=mc["mid_dim"],
                       out_dim=spec.group(group).latent_size, lr_mlp=mc["lr_mlp"])
        cdir = root / f"{group}_{hcfg['save_name']}"
        cdir.mkdir()
        (cdir / "args.json").write_text(json.dumps(hcfg, indent=2))
        save_flax_checkpoint(cdir / "checkpoint", "controller", init_params_(head, seed=1 + i))


def controls(batch: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return dict(
        orientation=(rng.uniform(-30, 30, size=(batch, 3))).astype(np.float32),
        age=rng.uniform(20, 70, size=(batch, 1)).astype(np.float32),
    )


def record_kernel_shapes(ctrl, ctl: dict) -> Counter:
    """(kernel, shape, dtype) -> launches in one main-path call, seen by
    forward hooks on the modules that call each kernel."""
    from gan_control_torch.models.blocks import EqualLinear, StyledConv, ToRGB

    seen: Counter = Counter()

    def out_hook(mod, args, out):
        seen[("fused_bias_act", tuple(out.shape), out.dtype)] += 1

    def skip_hook(mod, args, out):
        if len(args) > 2 and args[2] is not None:
            seen[("blur2x_up", tuple(args[2].shape), args[2].dtype)] += 1

    mods = [ctrl.model, *ctrl.fc_controls.values()]
    handles = []
    for root in mods:
        for m in root.modules():
            if (isinstance(m, EqualLinear) and m.activation == "fused_lrelu") or isinstance(m, StyledConv):
                handles.append(m.register_forward_hook(out_hook))
            elif isinstance(m, ToRGB):
                handles.append(m.register_forward_hook(skip_hook))
    try:
        ctrl.gen_batch_by_controls(batch_size=BATCH, latent=np.zeros((BATCH, 512), np.float32), **ctl)
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    return seen


def kernel_phase(shapes: Counter) -> dict:
    """Compare and time each kernel at every recorded shape, in f32 and bf16.
    Returns per-kernel totals over one main-path call: times and bounds
    summed over its launches at the path's own dtypes, the worst error."""
    from gan_control_torch.ops import kernels

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    totals = {n: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes_ms=0.0, ops_ms=0.0,
                      library_ms=None, launches=0, max_abs_err=0.0) for n in REPLACES}
    for (name, shape, path_dtype), count in sorted(shapes.items(), key=lambda kv: str(kv[0])):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            if name == "fused_bias_act":
                b = torch.randn(shape[-1], generator=gen, device="cuda")
                run = lambda: kernels.fused_bias_act(x, b)  # noqa: E731
                plain = lambda: kernels.fused_bias_act_plain(x, b)  # noqa: E731
                library = None
            else:
                c = shape[-1]
                k = torch.tensor([1.0, 3.0, 3.0, 1.0], device="cuda")
                w = (torch.outer(k, k) / 64.0 * 4.0)[None, None].repeat(c, 1, 1, 1).to(dtype)
                run = lambda: kernels.blur2x_up(x)  # noqa: E731
                plain = lambda: kernels.blur2x_up_plain(x)  # noqa: E731
                library = lambda: F.conv_transpose2d(  # noqa: E731
                    x.permute(0, 3, 1, 2), w, stride=2, padding=1, groups=c)
            got, want = run().float(), plain().float()
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            scale = max(1.0, float(want.abs().max()))
            tol = KERNEL_RTOL[dtype] * scale
            ok = err <= tol and bool(torch.isfinite(got).all())
            t_k, t_p = cuda_ms(run), cuda_ms(plain)
            t_lib = None
            if library is not None:
                lib_out = library().permute(0, 2, 3, 1).float()
                lib_err = float((lib_out - want).abs().max())
                t_lib = cuda_ms(library)
            t_b, by = bound(name, shape, dtype)
            log(f"kernel {name} {list(shape)} {str(dtype)[6:]} (x{count} on the path in "
                f"{str(path_dtype)[6:]}): max_abs_err {err:.3g} (tol {tol:.3g}) "
                f"kernel {t_k:.4f} ms plain {t_p:.4f} ms bound {t_b:.4f} ms ({by}, "
                f"{PEAK_BYTES_PER_S / 1e12:.2f} TB/s)"
                + ("" if t_lib is None else f" conv_transpose2d {t_lib:.4f} ms (err {lib_err:.3g})"))
            if not ok:
                fail(f"{name} disagrees with its plain version at {shape} {dtype}: {err} > {tol}")
            if dtype == path_dtype:
                tot = totals[name]
                tot["ms"] += count * t_k
                tot["plain_ms"] += count * t_p
                tot["bound_ms"] += count * t_b
                tot["bytes_ms" if by == "bytes" else "ops_ms"] += count * t_b
                if t_lib is not None:
                    tot["library_ms"] = (tot["library_ms"] or 0.0) + count * t_lib
                tot["max_abs_err"] = max(tot["max_abs_err"], err)
    return totals


def profile_phase(ctrl, z, ctl: dict, median_ms: float) -> None:
    """Device time by kernel over one warm main-path call (torch.profiler;
    the profiled call runs slower than an unprofiled one)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ctrl.gen_batch_by_controls(batch_size=BATCH, latent=z, **ctl)
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(ms for _, ms, _ in rows)
    log(f"profile: device busy {busy:.3f} ms per call in {sum(n for *_, n in rows)} kernels "
        f"= {100 * busy / median_ms:.1f}% of the {median_ms:.2f} ms median call")
    for key, ms, n in sorted(rows, key=lambda r: -r[1])[:15]:
        log(f"profile: {ms:8.3f} ms {100 * ms / max(busy, 1e-9):5.1f}% x{n:<4d} {key[:100]}")


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port on a GPU only")
    needed = [REPO / "gan_control_torch" / "ops" / "kernels.py", CONFIGS / "ffhq.json"]
    missing = [str(p) for p in needed if not p.exists()]
    if missing:
        fail(f"run from the root of a checkout; missing {missing}")
    build_root = REPO / "build" / "gan_control_torch"
    build_root.mkdir(parents=True, exist_ok=True)
    os.environ.setdefault("TRITON_CACHE_DIR", str(build_root / "triton_cache"))

    from gan_control_torch.inference.controller import Controller
    from gan_control_torch.ops import kernels

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(smi.splitlines()[0])
    name = torch.cuda.get_device_name(0)
    log(f"device: {name}, torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    report = kernels.build()
    for lib, r in report.items():
        regs = [ln.strip() for ln in r["log"].splitlines() if "registers" in ln or "spill" in ln]
        log(f"build {lib}: nvcc {r['seconds']:.1f} s; " + " | ".join(regs))
    log(f"build: CUDA libraries {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    probe = torch.ones(4, 8, device="cuda")
    kernels.fused_bias_act(probe, torch.zeros(8, device="cuda"))
    kernels.fused_bias_act(probe.bfloat16(), torch.zeros(8, device="cuda"))
    kernels.blur2x_up(probe.view(1, 2, 2, 8))
    torch.cuda.synchronize()
    log(f"build: first launches incl. Triton compile {time.perf_counter() - t0:.1f} s")

    with tempfile.TemporaryDirectory(dir=build_root) as tmp:
        root = Path(tmp) / "ffhq_controller"
        # 3. model directory
        t0 = time.perf_counter()
        write_controller_dir(root)
        ctrl = Controller(root)
        log(f"load: wrote and loaded the FFHQ-512 controller dir in {time.perf_counter() - t0:.1f} s; "
            f"synthesis {ctrl.model.dtype}, heads {sorted(ctrl.fc_controls)}")
        ctl = controls(BATCH, 1)
        shapes = record_kernel_shapes(ctrl, ctl)
        expected = {n: sum(c for (k, _, _), c in shapes.items() if k == n) for n in REPLACES}
        log(f"path: kernel launches per call by shape hooks {expected}")

        # 4. kernels
        totals = kernel_phase(shapes)

        # 5. main path
        torch.backends.cudnn.allow_tf32 = True  # defaults; synthesis is bf16
        z = np.random.default_rng(2).standard_normal((BATCH, 512)).astype(np.float32)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        img, _, latent_w = ctrl.gen_batch_by_controls(batch_size=BATCH, latent=z, **ctl)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        log(f"main path: launches {counts}")
        if tuple(img.shape) != (BATCH, 512, 512, 3) or not bool(torch.isfinite(img).all()):
            fail(f"bad main-path output {tuple(img.shape)}")
        if counts != expected or counts != {"fused_bias_act": 56 + 2 * 4 + 15, "blur2x_up": 7}:
            fail(f"launch counts {counts}, expected {expected} (79 and 7)")
        times = []
        for _ in range(7):
            t0 = time.perf_counter()
            ctrl.gen_batch_by_controls(batch_size=BATCH, latent=z, **ctl)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        med = statistics.median(times)
        log(f"main path: gen_batch_by_controls batch {BATCH} bf16 median {med:.2f} ms over "
            f"{len(times)} warm calls ({BATCH / med * 1e3:.1f} images/s); all {[round(t, 2) for t in times]}; "
            f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        profile_phase(ctrl, z, ctl, med)
        for n in REPLACES:
            totals[n]["launches"] = counts[n]
        del ctrl, img, latent_w

        # 6. card against CPU, f32, TF32 off
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        card = Controller(root, device="cuda", dtype=torch.float32)
        cpu = Controller(root, device="cpu", dtype=torch.float32)
        rng = np.random.default_rng(3)
        z1 = rng.standard_normal((1, 512)).astype(np.float32)
        noise = [rng.standard_normal(s).astype(np.float32) for s in card.model.noise_shapes(1)]
        card.set_noise(noise)
        cpu.set_noise(noise)
        ctl1 = controls(1, 4)
        t0 = time.perf_counter()
        want, _, _ = cpu.gen_batch_by_controls(latent=z1, normalize=False, **ctl1)
        t_cpu = time.perf_counter() - t0
        got, _, _ = card.gen_batch_by_controls(latent=z1, normalize=False, **ctl1)
        got = got.cpu()
        err = float((got - want).abs().max())
        tol = PARITY_RTOL * max(1.0, float(want.abs().max()))
        log(f"card vs cpu: batch 1 f32 TF32 off, max_abs_err {err:.3g} (tol {tol:.3g}, "
            f"max|img| {float(want.abs().max()):.3g}); cpu call {t_cpu:.1f} s")
        if not (err <= tol and bool(torch.isfinite(got).all())):
            fail("card and CPU disagree")

    entries = []
    for n in REPLACES:
        tot = totals[n]
        route, src = SOURCES[n]
        entries.append({
            "name": n, "route": route, "source": src, "replaces": REPLACES[n],
            "launches": tot["launches"], "max_abs_err": tot["max_abs_err"],
            "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": "bytes" if tot["bytes_ms"] >= tot["ops_ms"] else "operations",
            "library_ms": tot["library_ms"],
        })
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
