"""The ``serve`` driver: controlled generation through
``ServingController.generate``, one client, requests back to back.

Set-up writes a controller directory under ``TMPDIR`` (the configuration's G
and one FcStack head per controlled group, all with the benchmark's weights
from the seed), loads it, sets the static noise planes from the seed and
captures each bucket once. The window sends requests of the traffic's sizes,
every control set, uint8 output on the host, until ``seconds`` have passed.
Afterwards a sample of the finished requests drawn from the seed, with the
first of the largest size in it, is worked out again by the reference.

With ``trace`` the first ``trace_seconds`` of the window run under the
profiler, each request inside a span ``generate.b<bucket>``; the rest of the
window gives the rates.
"""

from __future__ import annotations

import contextlib
import gc
import json
import shutil
import tempfile
import time
import types
from pathlib import Path

import numpy as np
import torch

from portbench import traffic
from portbench import trace as trace_lib
from portbench.harness import check, log
from portbench.reference import build
from portbench.reference.compare import serve_numbers
from portbench.reference.lowp import LowerPrecision
from portbench.reference.serve_ref import ServeReference


def write_layout(root: Path, config: dict, g_state: dict, head_states: dict, dims: dict,
                 head_cfg: dict) -> Path:
    """``root/generator`` and ``root/<group>_bench`` in the port's layout,
    holding the given weights."""
    from gan_control_torch.utils.flax_bridge import save_flax_checkpoint

    def holder(sd):
        cpu = {k: v.detach().cpu() for k, v in sd.items()}
        return types.SimpleNamespace(state_dict=lambda: cpu)

    gen_dir = root / "generator"
    gen_dir.mkdir(parents=True)
    (gen_dir / "args.json").write_text(json.dumps(config))
    save_flax_checkpoint(gen_dir / "checkpoint", "g_ema", holder(g_state))
    for group, in_dim in dims.items():
        cdir = root / f"{group}_bench"
        cdir.mkdir()
        (cdir / "args.json").write_text(json.dumps({"model_config": dict(head_cfg, in_dim=in_dim)}))
        save_flax_checkpoint(cdir / "checkpoint", "controller", holder(head_states[group]))
    return root


class Requests:
    """The request stream of a seed: sizes from the traffic's law, z and
    controls from their own streams."""

    def __init__(self, tr: dict, seed: int, style_dim: int):
        self.sizes = traffic.Sizes(tr["sizes"], seed)
        self.inputs = traffic.stream(seed, 2)
        self.dims = tr["controls"]
        self.style_dim = style_dim

    def next(self) -> tuple[np.ndarray, dict[str, np.ndarray]]:
        n = self.sizes.next()
        z = self.inputs.standard_normal((n, self.style_dim), dtype=np.float32)
        controls = {g: self.inputs.standard_normal((n, d), dtype=np.float32)
                    for g, d in self.dims.items()}
        return z, controls


def run(cell: dict, config: dict, seed: int, seconds: float, trace: bool, device,
        fault: str | None = None, control: bool = False) -> dict:
    from gan_control_torch.inference.serving import ServingController

    tr = cell["traffic"]
    dims, head_cfg = tr["controls"], tr["head"]
    style_dim = config["model_config"].get("latent_size", 512)
    spec = build.group_spec(config)
    draw = build.Pool(seed, device)
    g_state = build.generator(config, spec, device, torch.float32, draw).state_dict()
    head_states = {g: h.state_dict() for g, h in
                   build.heads(spec, dims, head_cfg, device, draw).items()}
    tmp = Path(tempfile.mkdtemp(prefix="portbench_serve_"))
    try:
        write_layout(tmp, config, g_state, head_states, dims, head_cfg)
        serve = ServingController(tmp, buckets=tuple(tr["buckets"]), device=device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    noise = [draw.normal(s).clone() for s in serve.model.noise_shapes(1)]
    serve.set_noise(noise)
    host = {"G": {k: v.cpu() for k, v in g_state.items()},
            "heads": {g: {k: v.cpu() for k, v in sd.items()} for g, sd in head_states.items()},
            "noise": [n.cpu() for n in noise]}
    del g_state, head_states, draw
    warm = traffic.stream(seed, 4)
    for b in serve.buckets:
        for _ in range(2):
            serve.generate(latent=warm.standard_normal((b, style_dim), dtype=np.float32),
                           output=tr["output"],
                           **{g: warm.standard_normal((b, d), dtype=np.float32) for g, d in dims.items()})
    generate = serve.generate
    if fault == "altered_answer":
        def generate(**kw):
            img, lat, w = serve.generate(**kw)
            img = img.copy()
            img[0] = 255 - img[0]
            return img, lat, w

    requests = Requests(tr, seed, style_dim)
    keep_rng = traffic.stream(seed, 5)
    largest = max(traffic.size_block(tr["sizes"]))
    kept: list = []
    served: list[tuple[int, int, float, bool]] = []  # size, bucket, seconds, traced
    failed = 0
    prof = None
    if trace:
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                  torch.profiler.ProfilerActivity.CUDA])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_end = time.perf_counter()
    log("set-up done: layout loaded, buckets captured")
    if prof is not None:
        prof.__enter__()
        win = torch.profiler.record_function("window")
        win.__enter__()
    t0 = time.perf_counter()
    traced_until = t0 + tr["trace_seconds"] if trace else t0
    plain_t0 = t0
    while True:
        now = time.perf_counter()
        if now - t0 >= seconds:
            break
        if prof is not None and now >= traced_until:
            win.__exit__(None, None, None)
            prof.__exit__(None, None, None)
            prof_events = trace_lib.events(prof)
            prof = None
            plain_t0 = time.perf_counter()
        z, controls = requests.next()
        n = z.shape[0]
        bucket = serve.bucket_for(n)
        keep = keep_rng.random() < tr["check_rate"] or (n == largest and not any(
            r[0].shape[0] == largest for r in kept))
        span = (torch.profiler.record_function(f"generate.b{bucket}") if prof is not None
                else contextlib.nullcontext())
        t = time.perf_counter()
        try:
            with span:
                img, _, w = generate(latent=z, output=tr["output"], **controls)
        except RuntimeError as e:  # a failed request counts against the run
            failed += 1
            log(f"request of {n} failed: {e}")
            continue
        served.append((n, bucket, time.perf_counter() - t, prof is not None))
        if keep:
            kept.append((z, controls, img, w))
    t_end = time.perf_counter()
    if prof is not None:
        win.__exit__(None, None, None)
        prof.__exit__(None, None, None)
        prof_events = trace_lib.events(prof)
    memory_peak = torch.cuda.max_memory_reserved(device) if device.type == "cuda" else 0
    del serve
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    sizes = np.array([r[0] for r in served])
    lat = np.array([r[2] for r in served])
    plain = [r for r in served if not r[3]]
    out = {
        "setup_end": setup_end,
        "e2e": {"gen_images_per_s": float(sizes.sum() / (t_end - t0)),
                "gen_request_p95_ms": float(np.percentile(lat, 95) * 1e3)},
        "attempted": len(served) + failed, "failed": failed, "memory_peak": memory_peak,
        "run": {"requests": served, "plain_images": sum(r[0] for r in plain),
                "plain_requests": len(plain),
                "plain_s": t_end - plain_t0 if plain else 0.0},
    }
    if trace:
        out["trace"] = trace_lib.reduce(prof_events)

    log(f"window {t_end - t0:.3f} s, {len(served)} requests; reference checks {len(kept)}")
    ref = ServeReference(config, host["G"], host["heads"], dims, head_cfg, host["noise"], device)
    low = None
    if control:
        # the control takes the program's place: the reference in the
        # configuration's bf16, one precision lower
        low = ServeReference(config, host["G"], host["heads"], dims, head_cfg, host["noise"],
                             device, dtype=torch.bfloat16)
    pairs = []
    with build.exact():
        for z, controls, img, w in kept:
            ref_img, ref_w = ref(z, controls)
            if low is not None:
                with LowerPrecision():
                    img, w = low(z, controls)
            pairs.append((img, w, ref_img, ref_w))
    numbers = serve_numbers(pairs)
    out["checks"] = [check(k, numbers[k], limit) for k, limit in cell["limits"].items()]
    out["checked"] = {"requests": len(pairs), "images": int(sum(p[0].shape[0] for p in pairs))}
    out["numbers"] = numbers
    return out
