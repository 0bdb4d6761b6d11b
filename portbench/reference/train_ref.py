"""The training reference: the first iterations of the published cadence,
run by the frozen copy of the port's plain math in f32 (TF32 off), on the
benchmark's weights, reals and draws.

Every random input of the checked iterations is the benchmark's own
(:func:`Inputs`): the z of each step, G's injection noise and the path
length's noise are drawn by the benchmark from the seed and handed to the
program's steps (their ``z_list``, ``noise`` and ``path_noise``) and to the
reference's alike. ADA's transforms are the one draw that the program's
``augment`` takes from its own generator: they are recorded where the
program samples them (``training.ada.sample_affine`` and ``sample_color``)
and the reference applies them. What it records (:func:`recorder`) is what
the harness records of the program: each iteration's losses, each
optimizer step's gradient as the optimizer gets it (every leaf's norm, and
the whole gradient for the first iteration's steps), and each leaf's change
over the iterations.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from portbench.reference import build
from portbench.reference.frozen.training import ada
from portbench.reference.frozen.training.state import init_gan_state
from portbench.reference.frozen.training.train_step import (
    TrainStepConfig,
    d_reg_step,
    d_step,
    g_reg_step,
    g_step,
)


def step_config(tc: dict, mc: dict, predictor_dtype: str) -> TrainStepConfig:
    """The trainer's ``TrainStepConfig`` on the plain memory plan."""
    aug = tc.get("augment", {})
    return TrainStepConfig(
        batch=tc["batch"], mini_batch=tc["mini_batch"], r1=tc.get("r1", 1.0),
        d_reg_every=tc.get("d_reg_every", 16), g_reg_every=tc.get("g_reg_every", 4),
        path_regularize=tc.get("path_regularize", 2.0),
        path_batch_shrink=tc.get("path_batch_shrink", 2),
        g_moving_average=tc.get("g_moving_average", 10000), mixing=tc.get("mixing", 0.0),
        vanilla=mc.get("vanilla", False), style_dim=mc.get("latent_size", 512),
        ada_enabled=aug.get("enabled", False), ada_target=aug.get("ada_target", 0.6),
        ada_length=aug.get("ada_length", 500_000), ada_p_fixed=aug.get("p", 0.0),
        remat_predictors=False, predictor_dtype=predictor_dtype, remat_reg=False)


STEPS = ("d_step", "d_reg_step", "g_step", "g_reg_step")


class MissingInputs(RuntimeError):
    """The program did not run a step that the reference follows, or ran
    it without the draws it takes."""


class Inputs:
    """The random inputs of the checked iterations, drawn from ``seed`` on
    ``device`` as the steps ask for them and kept, per step kind in call
    order, for the reference: ``z`` (a tuple), ``noise`` (per layer),
    ``inject_index`` (with two z), ``path_noise`` (``g_reg_step``) and
    ``ada`` (the transforms the step's augmentations applied, in order, as
    ``("affine" | "color", matrices)``)."""

    def __init__(self, seed: int, device):
        self.gen = torch.Generator(device=device).manual_seed((seed * 1_000_003 + 17) % 2**63)
        self.device = device
        self.steps: dict[str, list[dict]] = {k: [] for k in STEPS}
        self.ada: list | None = None

    def randn(self, shape) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.gen, device=self.device)

    def step(self, name: str, batch: int | None = None, z_dim: int = 512, n_z: int = 1,
             noise_shapes=(), n_latent: int = 0, image_shape=None) -> dict:
        """A new record of step ``name``, with the draws it takes."""
        rec: dict = {"ada": []}
        if batch is not None:
            rec["z"] = tuple(self.randn((batch, z_dim)) for _ in range(n_z))
            rec["noise"] = [self.randn(s) for s in noise_shapes]
            if n_z > 1:
                rec["inject_index"] = int(torch.randint(1, n_latent, (), generator=self.gen,
                                                        device=self.device))
        if image_shape is not None:
            rec["path_noise"] = self.randn(image_shape)
        self.steps[name].append(rec)
        self.ada = rec["ada"]
        return rec

    def to(self, device) -> "Inputs":
        def move(x):
            if isinstance(x, torch.Tensor):
                return x.to(device)
            if isinstance(x, (list, tuple)):
                return type(x)(move(v) for v in x)
            if isinstance(x, dict):
                return {k: move(v) for k, v in x.items()}
            return x
        self.steps = move(self.steps)
        return self

    def same_as(self, other: "Inputs") -> bool:
        def eq(a, b):
            if isinstance(a, torch.Tensor):
                return isinstance(b, torch.Tensor) and a.shape == b.shape and torch.equal(
                    a.cpu(), b.cpu())
            if isinstance(a, (list, tuple)):
                return isinstance(b, (list, tuple)) and len(a) == len(b) and all(
                    eq(x, y) for x, y in zip(a, b))
            if isinstance(a, dict):
                return isinstance(b, dict) and a.keys() == b.keys() and all(eq(a[k], b[k]) for k in a)
            return a == b
        return eq(self.steps, other.steps)


def replay_augment(transforms: list):
    """ADA as the program applied it in one step: each call takes the next
    recorded affine and colour transforms."""
    it = iter(transforms)

    def augment_fn(img, p, generator=None):
        (ka, a), (kc, c) = next(it, (None, None)), next(it, (None, None))
        if ka != "affine" or kc != "color":
            raise MissingInputs("the program applied other augmentations than the reference")
        return ada.apply_color(ada.apply_affine(img, a.to(img.device)), c.to(img.device))
    return augment_fn


@contextlib.contextmanager
def recorder(g_opt, d_opt, g_ema, params: dict, keep: dict[str, int] | None = None):
    """Records, while active, each optimizer step's gradient as the
    optimizer gets it: every leaf's norm (``rec["grads"]``: ``("G" | "D",
    norms)`` in step order) and, for the first ``keep[tag]`` steps of each,
    the whole gradient (``rec["vectors"]``: ``(tag, flat f32 on the
    host)``); on exit, each leaf's change from its value at entry
    (``rec["change"]``: G, D and the EMA, norms per leaf). ``params``: name
    -> module of G, D."""
    keep = keep or {}
    rec = {"grads": [], "vectors": [], "change": {}}
    start = {k: [p.detach().float().clone() for p in m.parameters()] for k, m in
             (("G", params["G"]), ("D", params["D"]), ("G_ema", g_ema))}
    seen = {"G": 0, "D": 0}

    def hook(tag):
        def pre(opt, args, kwargs):
            ps = [p for grp in opt.param_groups for p in grp["params"]]
            grads = [p.grad.detach().float() if p.grad is not None else torch.zeros_like(p, dtype=torch.float32)
                     for p in ps]
            rec["grads"].append((tag, torch.stack([g.norm() for g in grads])))
            if seen[tag] < keep.get(tag, 0):
                rec["vectors"].append((tag, torch.cat([g.flatten() for g in grads]).cpu()))
            seen[tag] += 1
        return pre

    handles = [g_opt.register_step_pre_hook(hook("G")), d_opt.register_step_pre_hook(hook("D"))]
    try:
        yield rec
    finally:
        for h in handles:
            h.remove()
        for k, m in (("G", params["G"]), ("D", params["D"]), ("G_ema", g_ema)):
            rec["change"][k] = torch.stack([(p.detach().float() - p0).norm()
                                            for p, p0 in zip(m.parameters(), start[k])])


def to_host(rec: dict, metrics: list[dict]) -> dict:
    return {"losses": [{k: float(v) for k, v in m.items()} for m in metrics],
            "grads": [(t, n.cpu().numpy()) for t, n in rec["grads"]],
            "vectors": [(t, v.numpy()) for t, v in rec["vectors"]],
            "change": {k: v.cpu().numpy() for k, v in rec["change"].items()}}


def follow(config: dict, weights: dict, reals: list[np.ndarray], inputs: Inputs, device,
           ada_p: float | None = None, dtype: torch.dtype = torch.float32,
           predictor_dtype: str = "float32", keep: dict[str, int] | None = None) -> dict:
    """Iterations ``0 .. len(reals) - 1`` of the cadence from ``weights``
    (``build.weights``' state dicts), iteration ``i`` on the batch
    ``reals[i]`` (NHWC f32 in [-1, 1]), each step on its draws in
    ``inputs``. ``dtype`` is the synthesis and D type (f32 for the
    reference; the control runs the configuration's bf16 under ``lowp``).
    Returns the losses, gradients and changes on the host; raises
    :class:`MissingInputs` where the program took no draws for a step that
    the cadence runs."""
    mc, tc = config["model_config"], config["training_config"]
    spec = build.group_spec(config)
    g = build.generator(config, spec, device, dtype, None)
    g.load_state_dict(weights["G"])
    d = build.discriminator(config, device, dtype, None)
    d.load_state_dict(weights["D"])
    specs, nets = build.battery(tc, device, None)
    for name, m in build.distinct(nets).items():
        m.load_state_dict(weights["battery"][name])
    cfg = step_config(tc, mc, predictor_dtype)
    for m in build.distinct(nets).values():
        m.to(dtype=torch.float32 if predictor_dtype == "float32" else torch.bfloat16)
    # every draw is handed in: the state's generator is never read
    state = init_gan_state(g, d, tc, seed=0)
    if ada_p is not None:
        state.ada_p = torch.tensor(float(ada_p), device=device)
    taken = {k: iter(v) for k, v in inputs.to(device).steps.items()}

    def draws(name: str) -> dict:
        rec = next(taken[name], None)
        if rec is None:
            raise MissingInputs(f"the program ran fewer {name} calls than the cadence")
        aug = replay_augment(rec["ada"]) if cfg.ada_enabled else None
        return dict(rec, augment_fn=aug)

    metrics = []
    with recorder(state.g_opt, state.d_opt, state.g_ema, {"G": g, "D": d}, keep) as rec:
        for i, host_real in enumerate(reals):
            real = torch.from_numpy(host_real).to(device)
            m = {}
            if i % tc.get("d_every", 1) == 0:
                r = draws("d_step")
                m.update(d_step(state, cfg, spec, real, r["z"], noise=r["noise"],
                                inject_index=r.get("inject_index"), augment_fn=r["augment_fn"]))
            if i % cfg.d_reg_every == 0:
                m.update(d_reg_step(state, cfg, real))
            r = draws("g_step")
            m.update(g_step(state, cfg, spec, r["z"], noise=r["noise"],
                            inject_index=r.get("inject_index"), attr_losses=specs,
                            predictors=nets, augment_fn=r["augment_fn"]))
            if i % cfg.g_reg_every == 0:
                r = draws("g_reg_step")
                m.update(g_reg_step(state, cfg, r["z"], noise=r["noise"],
                                    inject_index=r.get("inject_index"), path_noise=r["path_noise"]))
            metrics.append(m)
    return dict(to_host(rec, metrics), battery=[f"g_{s.name}" for s in specs],
                sizes={"G": [p.numel() for p in g.parameters()],
                       "D": [p.numel() for p in d.parameters()]})
