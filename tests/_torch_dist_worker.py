"""One rank of the port's data-parallel tests: a gloo run on the CPU.

    python tests/_torch_dist_worker.py <job> <dir>

Each rank is started with torchrun's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) and
one intra-op thread; ``multihost.initialize(device="cpu")`` reads it. A job
reads ``<dir>/inputs.pt`` and writes what it found to ``<dir>/rank<r>.pt``.
The tests (``tests/test_torch_distributed.py``: job ``host``;
``tests/test_torch_distributed_train.py``: job ``train``) run the same
functions in one process at the global batch and hold the ranks to them;
job ``train`` also records Part A of ``tools/collective_scaling.py``.
This module imports torch and the port only, so that a rank starts quickly.
"""

from __future__ import annotations

import copy
import os
import signal
import socket
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch
from torch import nn

STYLE = 64
SIZE = 16
BATCH = 8
FEATURES = 16
REPO = Path(__file__).resolve().parent.parent


def start_ranks(job: str, out_dir: Path, world: int = 2) -> list:
    """``world`` ranks of ``job`` on a free localhost port, as torchrun
    starts them (one intra-op thread each); logs in ``<dir>/rank<r>.log``."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    base = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    base.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", MASTER_ADDR="127.0.0.1",
                MASTER_PORT=str(port), WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world))
    procs = []
    for r in range(world):
        log = open(out_dir / f"rank{r}.log", "w")
        procs.append((subprocess.Popen([sys.executable, __file__, job, str(out_dir)],
                                       env={**base, "RANK": str(r), "LOCAL_RANK": str(r)},
                                       stdout=log, stderr=subprocess.STDOUT), log))
    return procs


def finish_ranks(procs: list, out_dir: Path, timeout: float = 400) -> list[dict]:
    """Each rank's results, once all have exited 0. A rank that fails ends
    the others (they would wait in a collective) and raises with its log."""
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p, _ in procs):
            failed = [r for r, (p, _) in enumerate(procs) if p.poll() not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            log.close()
    bad = [r for r, (p, _) in enumerate(procs) if p.returncode != 0]
    if bad:
        logs = "\n".join(f"--- rank {r} (exit {procs[r][0].returncode}):\n"
                         + (out_dir / f"rank{r}.log").read_text()[-4000:] for r in bad)
        raise AssertionError(f"ranks {bad} failed\n{logs}")
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(len(procs))]


def snapshot(module: nn.Module) -> dict:
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def grads(module: nn.Module) -> dict:
    return {n: p.grad.detach().clone() for n, p in module.named_parameters() if p.grad is not None}


def floats(metrics: dict) -> dict:
    return {k: float(v) for k, v in metrics.items()}


# ---------------------------------------------------------------------------
# the models and inputs that both sides build
# ---------------------------------------------------------------------------


class TinyNet(nn.Module):
    """A small frozen "predictor": conv, mean pool, linear."""

    def __init__(self, out: int = FEATURES, seed: int = 5):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.conv = nn.Conv2d(3, 8, 3, padding=1)
        self.fc = nn.Linear(8, out)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.5)

    def forward(self, x):  # NHWC, in the net's dtype (the trainer casts the battery)
        y = torch.relu(self.conv(x.to(self.conv.weight.dtype).permute(0, 3, 1, 2)))
        return self.fc(y.mean(dim=(2, 3))).float()


def tiny_battery():
    """One contrastive loss on TinyNet's features (an unweighted
    intermediate layer and the embedding), on the spec's ``id`` group."""
    from gan_control_torch.losses.contrastive import ContrastiveConfig, pairwise_sq_l2
    from gan_control_torch.training.train_step import AttributeLossSpec

    cfg = ContrastiveConfig(intermediate_weights=(0.0,), last_layer_weight=1.0, lower_thres=(0.1,),
                            upper_thres=(1.0,), last_lower_thres=0.5, last_upper_thres=40.0,
                            focus_on=("not_same_as_last_layer", "same_as_last_layer"))
    spec = AttributeLossSpec(name="tiny_loss", group="id", cfg=cfg,
                             feature_fn=lambda m, imgs: [imgs.float().mean(dim=(1, 2)), m(imgs)],
                             dist_fn=pairwise_sq_l2)
    return (spec,), {"tiny_loss": TinyNet().requires_grad_(False)}


def group_spec(mini_batch: int = BATCH):
    from gan_control_torch.latent.groups import GroupSpec, LatentGroup

    half = mini_batch // 2
    groups = (LatentGroup("id", 0, 32, mb_start=0, mb_end=half, count_range=(2, 6)),
              LatentGroup("other", 32, 64, mb_start=half, mb_end=mini_batch, count_range=(2, 6)))
    return GroupSpec(groups=groups, mini_batch=mini_batch, style_dim=STYLE)


def tiny_models(seed: int = 0):
    """The tiny G (2-layer split mappings, injection-noise weights 0.3) and D."""
    from gan_control_torch.models.blocks import NoiseInjection, init_params_
    from gan_control_torch.models.discriminator import Discriminator
    from gan_control_torch.models.generator import Generator

    spec = group_spec()
    g = init_params_(Generator(size=SIZE, style_dim=STYLE, n_mlp=2, split_fc=True, max_channels=32,
                               fc_groups=spec.fc_dims()), seed=seed)
    with torch.no_grad():
        for m in g.modules():
            if isinstance(m, NoiseInjection):
                m.weight.fill_(0.3)
    return g, init_params_(Discriminator(size=SIZE, max_channels=32), seed=seed + 1)


def port_state(g_sd: dict, d_sd: dict, ada_p: float):
    from gan_control_torch.training.state import GANTrainState, reg_adam

    g, d = tiny_models()
    g.load_state_dict(g_sd)
    d.load_state_dict(d_sd)
    return GANTrainState(
        generator=g, discriminator=d, g_ema=copy.deepcopy(g).requires_grad_(False),
        g_opt=reg_adam(g.parameters(), 2e-3, 4), d_opt=reg_adam(d.parameters(), 2e-3, 16),
        mean_path_length=torch.zeros(()), rng=torch.Generator().manual_seed(0),
        ada_p=torch.tensor(ada_p))


def step_inputs(seed: int = 20) -> dict:
    rng = np.random.default_rng(seed)

    def randn(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))

    return {"real": randn(BATCH, SIZE, SIZE, 3, scale=0.5),
            "z_d": [randn(BATCH, STYLE), randn(BATCH, STYLE)],
            "z_g": [randn(BATCH, STYLE)],
            "z_reg": [randn(BATCH // 2, STYLE), randn(BATCH // 2, STYLE)]}


def rank_rows(t: torch.Tensor, rank: int, world: int) -> torch.Tensor:
    n = t.shape[0] // world
    return t[rank * n : (rank + 1) * n]


def run_steps(inputs: dict, rank: int = 0, world: int = 1,
              steps=("d_step", "d_reg_step", "g_step", "g_reg_step")) -> dict:
    """The four steps in a row from one state (ADA adaptive from p 0.3, the
    tiny battery, style mixing in d_step and g_reg_step) on the rank's rows
    of each global input; each step's metrics and gradients, then the
    parameters, the EMA, ``ada_p`` and the path-length mean."""
    from gan_control_torch.training import ada
    from gan_control_torch.training import train_step as ts

    state = port_state(inputs["g_sd"], inputs["d_sd"], 0.3)
    cfg = ts.TrainStepConfig(batch=BATCH, mini_batch=BATCH, style_dim=STYLE, ada_enabled=True,
                             remat_predictors=True)
    spec = group_spec()
    attr_losses, predictors = tiny_battery()
    local = {k: ([rank_rows(z, rank, world) for z in v] if isinstance(v, list)
                 else rank_rows(v, rank, world))
             for k, v in inputs.items() if k in ("real", "z_d", "z_g", "z_reg")}
    calls = {
        "d_step": lambda: ts.d_step(state, cfg, spec, local["real"], local["z_d"],
                                    augment_fn=ada.augment),
        "d_reg_step": lambda: ts.d_reg_step(state, cfg, local["real"]),
        "g_step": lambda: ts.g_step(state, cfg, spec, local["z_g"], attr_losses=attr_losses,
                                    predictors=predictors, augment_fn=ada.augment),
        "g_reg_step": lambda: ts.g_reg_step(state, cfg, local["z_reg"]),
    }
    out = {}
    for name in steps:
        metrics = calls[name]()
        module = state.discriminator if name.startswith("d_") else state.generator
        out[name] = {"metrics": floats(metrics), "grads": grads(module)}
    out["final"] = {"g": snapshot(state.generator), "d": snapshot(state.discriminator),
                    "g_ema": snapshot(state.g_ema), "ada_p": float(state.ada_p),
                    "mean_path_length": float(state.mean_path_length), "step": state.step}
    return out


def trainer_config(results_dir: Path | None = None) -> dict:
    """configs/ffhq.json cut to size 16 (batch 16, f32, synthetic data)."""
    import json

    repo = Path(__file__).resolve().parent.parent
    config = json.loads((repo / "gan_control_tpu" / "configs" / "ffhq.json").read_text())
    config["model_config"].update(size=SIZE, max_channels=16, n_mlp=2, mixed_precision=False)
    config["training_config"].update(log_every=1, save_images_interval=10**6,
                                     save_nets_interval=10**6)
    config["data_config"] = {"data_set_name": "synthetic"}
    if results_dir is not None:
        config["results_dir"] = str(results_dir)
    return config


def run_trainer(config: dict, iters: int, init_dirs: bool, signal_at: int | None = None):
    """``dry_run()`` and ``train(iters)`` of a GeneratorTrainer with the tiny
    battery; with ``signal_at`` this process sends itself SIGTERM during
    that iteration. Returns the trainer and the iterations it ran."""
    from gan_control_torch.trainers.generator_trainer import GeneratorTrainer

    attr_losses, predictors = tiny_battery()
    tr = GeneratorTrainer(config=config, init_dirs=init_dirs, device="cpu",
                          attr_losses=attr_losses, predictors=predictors)
    ran = []
    one_iteration = tr.one_iteration

    def counted(i, real=None):
        if real is None:
            ran.append(i)
            if i == signal_at:
                os.kill(os.getpid(), signal.SIGTERM)
        return one_iteration(i, real)

    tr.one_iteration = counted
    try:
        tr.dry_run()
        tr.train(iters)
    finally:
        tr.close()
    return tr, ran


def trainer_result(tr, ran) -> dict:
    s = tr.state
    return {"ran": ran, "step": s.step, "start_iter": tr.start_iter, "g": snapshot(s.generator),
            "d": snapshot(s.discriminator), "g_ema": snapshot(s.g_ema),
            "g_opt": copy.deepcopy(s.g_opt.state_dict()), "d_opt": copy.deepcopy(s.d_opt.state_dict()),
            "metrics": tr.metrics_history, "save_dir": tr.save_dir}


# ---------------------------------------------------------------------------
# host pieces
# ---------------------------------------------------------------------------


def coupled_r1(x: torch.Tensor, w: torch.Tensor, k: torch.Tensor):
    """An R1-shaped second-order loss through the minibatch stddev: y =
    stddev(x * w), s = sum(y^2 k), the penalty mean(|ds/dx|^2) over rows.
    Returns (y, ds/dx, penalty, w's gradient of the penalty averaged over
    ranks)."""
    from gan_control_torch.models.blocks import minibatch_stddev
    from gan_control_torch.utils import collectives

    w = w.detach().clone().requires_grad_(True)
    with collectives.sharded_batch():
        x = x.detach().clone().requires_grad_(True)
        y = minibatch_stddev(x * w)
        (gx,) = torch.autograd.grad((y.square() * k).sum(), x, create_graph=True)
        penalty = gx.square().reshape(gx.shape[0], -1).sum(dim=1).mean()
        penalty.backward()
        collectives.mean_grads_([w])
        return y.detach(), gx.detach(), float(collectives.mean_metrics({"p": penalty.detach()})["p"]), w.grad


def coupled_mean(x: torch.Tensor, w: torch.Tensor):
    """A first-order loss whose rows couple through gathered features: the
    per-row mean of ``x * w`` against every row's (a contrastive-shaped
    all-pairs term) plus a per-row term; w's gradient averaged over ranks."""
    from gan_control_torch.utils import collectives

    w = w.detach().clone().requires_grad_(True)
    with collectives.sharded_batch():
        f = (x * w).mean(dim=(1, 2))
        full = collectives.gather_batch(f)
        pairs = torch.cdist(full, full).square().mean()
        loss = pairs + f.square().mean()
        loss.backward()
        collectives.mean_grads_([w])
        return float(collectives.mean_metrics({"l": loss.detach()})["l"]), w.grad


def fid_chunks(inputs: dict) -> dict:
    """Two FID chunks of the tiny G through a TinyNet "Inception", and the
    FID of 12 samples against the statistics pickle."""
    from gan_control_torch.evaluation import fid as fid_lib

    g, _ = tiny_models()
    g.load_state_dict(inputs["g_sd"])
    chunk = fid_lib.make_gen_feature_fn(g.eval(), TinyNet(seed=9), batch=BATCH, style_dim=STYLE)
    gen = torch.Generator().manual_seed(3)
    feats = torch.cat([chunk(gen), chunk(gen)])
    fid = fid_lib.evaluate_fid(chunk, None, inputs["stats_path"], n_samples=12, batch_size=BATCH,
                               generator=torch.Generator().manual_seed(0))
    return {"features": feats, "fid": fid}


def controller_step(inputs: dict, batch: int = BATCH) -> dict:
    """One ControllerTrainer step (latent_rec and attribute_rec through a
    differentiable stand-in predictor) on the table's first ``batch`` rows;
    the head's gradients and the metrics."""
    from gan_control_torch.trainers.controller_trainer import ControllerTrainer

    def predict(img):
        return img.float().mean(dim=(1, 2))

    tr = ControllerTrainer(config=inputs["ctrl_config"], init_dirs=False, device="cpu",
                           predict_fn=predict,
                           controller_criterion=lambda p, t: torch.mean(torch.square(p - t)))
    controls, w = inputs["controls"][:batch], inputs["latents_w"][:batch]
    metrics = tr.train_step(controls, w)
    return {"grads": grads(tr.controller), "metrics": floats(metrics),
            "head": snapshot(tr.controller)}


def host_job(inputs: dict, out_dir: Path) -> dict:
    from gan_control_torch import calc_inception, make_attributes_df
    from gan_control_torch.utils import collectives, mesh, multihost

    rank, size = multihost.initialize(device="cpu")
    res: dict = {"rank": rank, "size": size, "index": multihost.process_index(),
                 "count": multihost.process_count(),
                 "backend": torch.distributed.get_backend(),
                 "rows": mesh.data_batch_sharding(BATCH), "indivisible": mesh.data_batch_sharding(7),
                 "rows_of_16": collectives.rows_of_rank(16),
                 "broadcast": collectives.broadcast_object(f"from rank {rank}"),
                 "any_one": collectives.any_rank(rank == 1), "any_none": collectives.any_rank(False),
                 "metrics": floats(collectives.mean_metrics({"a": torch.tensor(float(rank)),
                                                             "b": torch.tensor(2.0)}))}
    rows = res["rows"]
    x, w, k = inputs["x"], inputs["w"], inputs["k"]
    res["r1"] = coupled_r1(x[rows], w, k[rows])
    res["mean"] = coupled_mean(x[rows], w)
    res["fid"] = fid_chunks(inputs)
    sweep = ["--model_dir", str(inputs["run_dir"]), "--batch_size", "4", "--number_of_samples", "8",
             "--device", "cpu"]
    make_attributes_df.main(sweep + ["--save_path", str(out_dir / "sharded.npz")])
    make_attributes_df.main(sweep + ["--save_path", str(out_dir / "whole.npz"), "--no_shard"])
    calc_inception.main(["--path", str(inputs["image_dir"]), "--size", "16", "--batch", "4",
                         "--n_samples", "8", "--save_path", str(out_dir / "stats_sharded.pkl"),
                         "--device", "cpu"])
    res["controller"] = controller_step(inputs)
    try:
        controller_step(inputs, batch=BATCH - 1)
    except ValueError as e:
        res["indivisible_controller"] = str(e)
    return res


# ---------------------------------------------------------------------------
# the training job
# ---------------------------------------------------------------------------


def train_job(inputs: dict, out_dir: Path) -> dict:
    from gan_control_torch.tools import collective_scaling
    from gan_control_torch.utils import multihost

    rank, size = multihost.initialize(device="cpu")
    res: dict = {"rank": rank, "steps": run_steps(inputs, rank, size),
                 "d_reg_only": run_steps(inputs, rank, size, steps=("d_reg_step",)),
                 "collective_scaling": collective_scaling.step_calls(rank, size)}
    tr, ran = run_trainer(trainer_config(), 3, init_dirs=False)
    res["trainer"] = trainer_result(tr, ran)
    # SIGTERM on rank 1 alone during iteration 1; then a resume by both
    tr, ran = run_trainer(trainer_config(out_dir / "runs"), 6, init_dirs=True,
                          signal_at=1 if rank == 1 else None)
    res["preempted"] = trainer_result(tr, ran)
    config = trainer_config()
    config["ckpt_config"] = {"enabled": True, "ckpt": str(tr.save_dir / "checkpoint" / "000002.ckpt")}
    tr, ran = run_trainer(config, 3, init_dirs=False)
    res["resumed"] = trainer_result(tr, ran)
    return res


def main() -> None:
    job, out_dir = sys.argv[1], Path(sys.argv[2])
    torch.set_num_threads(1)
    rank = int(os.environ["RANK"])
    inputs = torch.load(out_dir / "inputs.pt", weights_only=False)
    try:
        res = {"host": host_job, "train": train_job}[job](inputs, out_dir)
    except Exception:  # noqa: BLE001 — reported to the test through the log
        traceback.print_exc()
        res = {"error": True}
    torch.save(res, out_dir / f"rank{rank}.pt")
    if "error" in res:
        sys.exit(1)


if __name__ == "__main__":
    main()
