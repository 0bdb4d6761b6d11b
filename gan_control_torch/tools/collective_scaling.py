"""What a data-parallel iteration costs across cards: the collectives each
train step issues, and a projection of weak and strong scaling (the
counterpart of the JAX package's ``tools/ici_scaling.py``).

    python -m gan_control_torch.tools.collective_scaling --iteration_ms MS
        [--worlds 2 4] [--out build/gan_control_torch/tools/collective_scaling.json]

Part A (executed). The four step kinds (``d_step``, ``g_step`` with a
contrastive loss on stand-in features, ``d_reg_step``, ``g_reg_step``) at
the JAX tool's small shapes (size 16, ``max_channels`` 32, batch 16,
mini-batch 8, two latent groups) on N gloo ranks on the CPU, each rank on its
rows of the global batch, every collective recorded
(``utils.collectives.recording``): per step kind and op, the calls and
bytes; the all-reduce bytes over the gradient bytes of the net the step
updates (the JAX tool's ``traffic_ratio``; the port all-reduces every
gradient of a step in one flat tensor, so the gradients' share reads 1.00);
and each gather with the tensor it carries. A step kind whose gradient
all-reduce moves no bytes at N >= 2 raises, as the JAX tool does.

Part B (analytic). The FFHQ-512 G and D parameter bytes (the port's modules
built on the ``meta`` device, as the JAX tool's flagship), the single-card
plain iteration at batch 16 (``--iteration_ms``: measured on the card by the
caller) and the interconnect figures below give the non-overlapped ring
all-reduce per iteration (the cadence-amortised gradient bytes of the four
steps, scaled by Part A's largest traffic ratio) and, at 1, 2, 4, 8 and 16
cards, the weak scaling (batch 16 per card) and the strong scaling (global
batch 16) that it leaves. It is a projection from those inputs, not a
measurement of several cards.

The output JSON names each input with its source, and the card (name and
power limit as nvidia-smi prints them) where one is present.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import tempfile
from pathlib import Path

import numpy as np
import torch

# NVIDIA H100 SXM data sheet: NVLink 4, 900 GB/s per GPU, both directions
# together. A ring all-reduce sends and receives at once, so it runs at the
# one-way rate.
NVLINK_BIDIRECTIONAL = 900e9
NVLINK_RING_BW = NVLINK_BIDIRECTIONAL / 2
CARDS_PER_NODE = 8
# NVIDIA DGX H100 data sheet: one ConnectX-7 400 Gb/s (NDR InfiniBand) port
# per GPU, 50 GB/s each way. Beyond a node each card's share of the ring is
# taken to cross its own port at that rate (the worst case).
INTER_NODE_RING_BW = 400e9 / 8
SOURCES = {
    "nvlink_ring_bw": "NVIDIA H100 SXM data sheet: NVLink 900 GB/s per GPU bidirectional, 450 GB/s each way",
    "inter_node_ring_bw": "NVIDIA DGX H100 data sheet: 8x ConnectX-7 400 Gb/s InfiniBand, one per GPU, "
                          "50 GB/s each way",
    "iteration_ms": "the caller's single-card plain iteration (d_step + g_step), FFHQ-512, batch 16",
}
BATCH_PER_CARD = 16
CARDS = (1, 2, 4, 8, 16)
STEP_KINDS = ("d_step", "g_step", "d_reg_step", "g_reg_step")
# the JAX tool's small steps (tools/ici_scaling.py build_small_steps)
SIZE, STYLE, MINI_BATCH, BATCH = 16, 64, 8, 16
DEFAULT_OUT = Path(__file__).resolve().parents[2] / "build" / "gan_control_torch" / "tools" / \
    "collective_scaling.json"


# ---------------------------------------------------------------------------
# Part A: the collectives of the four steps on N ranks
# ---------------------------------------------------------------------------


def small_steps(seed: int = 0):
    """(state, step config, group spec, the contrastive spec, its stand-in
    predictors) of the JAX tool's small steps, built by every rank alike."""
    from gan_control_torch.latent.groups import GroupSpec, LatentGroup
    from gan_control_torch.losses.contrastive import ContrastiveConfig, pairwise_sq_l2
    from gan_control_torch.models.blocks import init_params_
    from gan_control_torch.models.discriminator import Discriminator
    from gan_control_torch.models.generator import Generator
    from gan_control_torch.training import train_step as ts
    from gan_control_torch.training.state import init_gan_state

    spec = GroupSpec(groups=(LatentGroup("id", 0, 32, mb_start=0, mb_end=4),
                             LatentGroup("other", 32, 64, mb_start=4, mb_end=8)),
                     mini_batch=MINI_BATCH, style_dim=STYLE)
    g = init_params_(Generator(size=SIZE, style_dim=STYLE, n_mlp=2, split_fc=True, max_channels=32,
                               fc_groups=spec.fc_dims()), seed=seed)
    d = init_params_(Discriminator(size=SIZE, max_channels=32), seed=seed + 1)
    state = init_gan_state(g, d, {"lr_g": 2e-3, "lr_d": 2e-3, "g_reg_every": 4, "d_reg_every": 16}, seed=seed)
    cfg = ts.TrainStepConfig(batch=BATCH, mini_batch=MINI_BATCH, style_dim=STYLE)

    def fake_features(_, images):
        return [images.float().reshape(images.shape[0], 4, -1).mean(dim=2), images.float().mean(dim=(1, 2))]

    attr = (ts.AttributeLossSpec(
        name="embedding_loss", group="id",
        cfg=ContrastiveConfig(intermediate_weights=(0.0,), last_layer_weight=1.0, lower_thres=(0.1,),
                              upper_thres=(0.5,), last_lower_thres=0.1, last_upper_thres=1.0,
                              focus_on=("not_same_as_last_layer", "same_as_last_layer")),
        feature_fn=fake_features, dist_fn=pairwise_sq_l2),)
    return state, cfg, spec, attr, {"embedding_loss": None}


def step_calls(rank: int, world: int, seed: int = 0) -> dict:
    """This rank's recorded collectives of each step kind (one call each,
    in the order of ``STEP_KINDS``, on its rows of seeded global inputs),
    with the gradient bytes of the net each step updates."""
    from gan_control_torch.training import train_step as ts
    from gan_control_torch.utils import collectives

    state, cfg, spec, attr, predictors = small_steps(seed)
    rng = np.random.default_rng(seed + 10)

    def rows(*shape):
        full = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        n = shape[0] // world
        return full[rank * n:(rank + 1) * n]

    path_batch = max(BATCH // cfg.path_batch_shrink, world)
    run = {
        "d_step": lambda: ts.d_step(state, cfg, spec, rows(BATCH, SIZE, SIZE, 3) * 0.5, [rows(BATCH, STYLE)]),
        "g_step": lambda: ts.g_step(state, cfg, spec, [rows(BATCH, STYLE)], attr_losses=attr,
                                    predictors=predictors),
        "d_reg_step": lambda: ts.d_reg_step(state, cfg, rows(BATCH, SIZE, SIZE, 3) * 0.5),
        "g_reg_step": lambda: ts.g_reg_step(state, cfg, [rows(path_batch, STYLE)]),
    }
    param_bytes = {net: sum(p.numel() * p.element_size() for p in m.parameters())
                   for net, m in (("d", state.discriminator), ("g", state.generator))}
    out = {"param_bytes": param_bytes, "steps": {}}
    for kind in STEP_KINDS:
        calls: list = []
        with collectives.recording(calls):
            run[kind]()
        out["steps"][kind] = calls
    return out


def _rank_main(rank: int, world: int, port: int, out_dir: str) -> None:
    from gan_control_torch.utils import multihost

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    multihost.initialize(device="cpu")
    try:
        torch.save(step_calls(rank, world), Path(out_dir) / f"rank{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()


def run_ranks(world: int) -> list[dict]:
    """Each of ``world`` gloo ranks' ``step_calls`` (spawned processes on
    the CPU, one thread each)."""
    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as out:
        mp.start_processes(_rank_main, args=(world, port, out), nprocs=world, start_method="spawn")
        return [torch.load(Path(out) / f"rank{r}.pt", weights_only=False) for r in range(world)]


def summarise(world: int, rank0: dict) -> dict:
    """Part A's record of one world size, from rank 0's calls."""
    steps = {}
    for kind, calls in rank0["steps"].items():
        grad_bytes = rank0["param_bytes"][kind[0]]
        ops: dict = {}
        for c in calls:
            o = ops.setdefault(c.op, {"calls": 0, "bytes": 0})
            o["calls"] += 1
            o["bytes"] += c.nbytes
        reduce_bytes = ops.get("all_reduce", {}).get("bytes", 0)
        grads = [c for c in calls if c.what == "gradients"]
        if world >= 2 and not sum(c.nbytes for c in grads):
            raise RuntimeError(f"{kind} all-reduced no gradient bytes on {world} ranks: the step ran unsharded; "
                               "refusing to write a record")
        steps[kind] = {
            "ops": ops,
            "grad_bytes": grad_bytes,
            "gradient_all_reduces": len(grads),
            "gradient_ratio": sum(c.nbytes for c in grads) / grad_bytes,
            "traffic_ratio": reduce_bytes / grad_bytes,
            "calls": [{"op": c.op, "what": c.what, "shape": list(c.shape), "dtype": c.dtype, "bytes": c.nbytes}
                      for c in calls],
        }
    return {"world": world, "batch": BATCH, "param_bytes": rank0["param_bytes"], "steps": steps}


# ---------------------------------------------------------------------------
# Part B: the projection
# ---------------------------------------------------------------------------


def flagship_param_bytes() -> dict[str, int]:
    """The FFHQ-512 G and D parameter bytes (f32, as the gradients), the
    modules built on the ``meta`` device with the JAX tool's flagship
    arguments and configs/ffhq.json's latent groups."""
    from gan_control_torch.models.discriminator import Discriminator
    from gan_control_torch.models.factory import build_group_spec
    from gan_control_torch.models.generator import Generator

    config = json.loads((Path(__file__).resolve().parents[2] / "gan_control_tpu" / "configs" / "ffhq.json")
                        .read_text())
    spec = build_group_spec(config)
    with torch.device("meta"):
        g = Generator(size=512, style_dim=512, n_mlp=8, split_fc=True, fc_groups=spec.fc_dims())
        d = Discriminator(size=512)
    return {name: sum(p.numel() * p.element_size() for p in m.parameters()) for name, m in (("g", g), ("d", d))}


def ring_allreduce_s(nbytes: float, n: int, bw: float) -> float:
    """A ring all-reduce of ``nbytes`` over ``n`` cards at ``bw`` bytes/s
    each way, not overlapped with compute (the worst case)."""
    if n <= 1:
        return 0.0
    return 2.0 * (n - 1) / n * nbytes / bw


def project_scaling(pb: dict[str, int], iteration_ms: float, ring_bw: float, inter_node_bw: float | None = None,
                    traffic_ratio: float = 1.0, cards_per_node: int = CARDS_PER_NODE) -> list[dict]:
    """Weak (batch 16 per card) and strong (global batch 16) scaling at
    ``CARDS``: the all-reduce bytes of an iteration on the cadence (every
    ``d_step`` and ``g_step``, the regularisation steps at 1/16 and 1/4),
    at ``ring_bw`` within a node and ``inter_node_bw`` (default: the same)
    beyond ``cards_per_node``. The rows and their rounding are the JAX
    tool's."""
    ar_bytes = (pb["d"] * (1 + 1 / 16) + pb["g"] * (1 + 1 / 4)) * traffic_ratio
    rows = []
    for n in CARDS:
        bw = ring_bw if n <= cards_per_node or inter_node_bw is None else inter_node_bw
        t_ar = ring_allreduce_s(ar_bytes, n, bw) * 1e3
        weak_iter = iteration_ms + t_ar
        weak_imgs = BATCH_PER_CARD * n / (weak_iter / 1e3)
        strong_iter = iteration_ms / n + t_ar
        strong_imgs = BATCH_PER_CARD / (strong_iter / 1e3)
        rows.append({
            "chips": n,
            "allreduce_ms": round(t_ar, 2),
            "weak_ms_per_iter": round(weak_iter, 1),
            "weak_imgs_per_s": round(weak_imgs, 1),
            "weak_efficiency": round(weak_imgs / (n * BATCH_PER_CARD / (iteration_ms / 1e3)), 4),
            "strong_ms_per_iter": round(strong_iter, 1),
            "strong_imgs_per_s": round(strong_imgs, 1),
        })
    return rows


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------


def card() -> dict | None:
    """The card's name and power limit as nvidia-smi prints them; None
    without a card."""
    if not torch.cuda.is_available():
        return None
    from gan_control_torch.tools.convergence import device_line

    return device_line(torch.device("cuda"))


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iteration_ms", type=float, required=True,
                    help="the single-card plain iteration (d_step + g_step) at FFHQ-512, batch 16, measured "
                    "on the card")
    ap.add_argument("--worlds", type=int, nargs="+", default=[2, 4], help="gloo ranks of Part A")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    args = ap.parse_args(argv)

    results = {"card": card(), "collectives": [], "flagship_param_bytes": None, "inputs": {},
               "projection": None,
               "note": "Part B is a projection from the inputs, not a measurement on several cards"}
    for world in args.worlds:
        rec = summarise(world, run_ranks(world)[0])
        results["collectives"].append(rec)
        for kind, st in rec["steps"].items():
            ops = ", ".join(f"{op} {o['calls']} calls {o['bytes']} B" for op, o in st["ops"].items())
            print(f"world {world} {kind}: {ops}; gradients {st['gradient_all_reduces']} all-reduce(s), "
                  f"{st['gradient_ratio']:.2f}x the {st['grad_bytes']} B of gradients; all-reduce traffic "
                  f"{st['traffic_ratio']:.3f}x", flush=True)
            for c in st["calls"]:
                if c["op"] == "all_gather" or c["what"].startswith("backward of gather"):
                    print(f"    {c['op']} {c['what']}: {c['dtype']}{c['shape']} {c['bytes']} B", flush=True)

    pb = flagship_param_bytes()
    results["flagship_param_bytes"] = pb
    traffic_ratio = max(st["traffic_ratio"] for rec in results["collectives"] for st in rec["steps"].values())
    results["traffic_ratio"] = traffic_ratio
    results["inputs"] = {
        "iteration_ms": {"value": args.iteration_ms, "source": SOURCES["iteration_ms"]},
        "nvlink_ring_bw": {"value": NVLINK_RING_BW, "source": SOURCES["nvlink_ring_bw"]},
        "inter_node_ring_bw": {"value": INTER_NODE_RING_BW, "source": SOURCES["inter_node_ring_bw"]},
        "cards_per_node": CARDS_PER_NODE,
        "traffic_ratio": {"value": traffic_ratio, "source": "Part A, the largest over step kinds and worlds"},
    }
    print(f"FFHQ-512 parameters: G {pb['g']} B, D {pb['d']} B (f32 gradients); traffic ratio "
          f"{traffic_ratio:.3f}; single-card iteration {args.iteration_ms:.2f} ms", flush=True)
    rows = project_scaling(pb, args.iteration_ms, NVLINK_RING_BW, INTER_NODE_RING_BW, traffic_ratio)
    results["projection"] = rows
    print("projection (not a measurement): NVLink within a node of 8, InfiniBand beyond", flush=True)
    print(f"{'cards':>5} {'AR ms':>7} {'weak ms/it':>10} {'weak img/s':>10} {'eff':>7} {'strong ms/it':>12} "
          f"{'strong img/s':>12}")
    for r in rows:
        print(f"{r['chips']:>5} {r['allreduce_ms']:>7.2f} {r['weak_ms_per_iter']:>10.1f} "
              f"{r['weak_imgs_per_s']:>10.1f} {r['weak_efficiency']:>7.2%} {r['strong_ms_per_iter']:>12.1f} "
              f"{r['strong_imgs_per_s']:>12.1f}", flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=1))
    print(f"wrote {out}", flush=True)
    return results


if __name__ == "__main__":
    main()
