"""The ``train`` driver: phase-1 training through
``GeneratorTrainer.one_iteration`` at the published cadence.

Set-up builds the trainer as ``train_generator.py`` does (the config's
battery from ``build_attr_losses``), loads the benchmark's weights from the
seed into G, its EMA, D and the battery, and feeds it a pool of seeded
uniform reals through its own ``DeviceFeeder``. It then runs the first
iterations of a cadence (iteration 0 runs all four step kinds, iteration 1
a plain one), with the benchmark's draws handed to the program's steps
(``train_ref.Inputs``) and what the correctness check compares recorded;
the same trainer goes on into the window.

The window runs whole cadences of ``d_reg_every`` iterations, from
iteration 0 of a cadence, and starts no cadence that would end past
``seconds`` (by the last cadence's length), so it holds R1 and the path
length in their trained ratio; the rate is every real image over the time
of those cadences. With ``trace`` the window's first cadence runs under the
profiler (spans ``next_real`` and ``one_iteration``), its second with
``profile_steps`` (a device sync around each step), and the rest plain;
at least three cadences are run then.

After the window the trainer is freed and the reference follows the same
first iterations from the same weights, reals and draws.
"""

from __future__ import annotations

import contextlib
import gc
import inspect
import itertools
import time

import torch

from portbench import traffic
from portbench import trace as trace_lib
from portbench.harness import check, log
from portbench.reference import build, train_ref
from portbench.reference.compare import train_detail, train_numbers
from portbench.reference.lowp import LowerPrecision

# faults planted in the program's steps, for the readings and their tests
FAULTS = ("frozen_state", "half_batch", "half_batch_r1", "half_batch_path",
          "half_batch_battery", "sign_flip", "drop_battery")


def first_steps(tc: dict) -> dict[str, int]:
    """Optimizer steps of each optimizer in iteration 0: D's step and R1,
    G's step and path length."""
    return {"D": 2, "G": 2 if tc.get("g_reg_every", 4) else 1}


def _half(t: torch.Tensor) -> torch.Tensor:
    return t[: t.shape[0] // 2]


def _faulty(fault: str | None, trainer) -> contextlib.AbstractContextManager:
    """A fault planted in the program's steps: ``frozen_state`` leaves every
    parameter unchanged; ``half_batch`` leaves half of the batch out of D's
    and G's adversarial losses, ``half_batch_r1`` out of R1,
    ``half_batch_path`` out of the path length and ``half_batch_battery``
    out of each contrastive loss (half of the pairs and half of the other
    rows), the mean taken over the rest; ``sign_flip`` hands both
    optimizers their gradients negated; ``drop_battery`` leaves the
    battery's losses out of G's gradient (their values still reported)."""
    from gan_control_torch.training import train_step as ts

    stack = contextlib.ExitStack()

    def patch(name, fn):
        orig = getattr(ts, name)
        setattr(ts, name, fn(orig))
        stack.callback(setattr, ts, name, orig)

    if fault == "frozen_state":
        for opt in (trainer.state.g_opt, trainer.state.d_opt):
            orig = opt.step
            opt.step = lambda *a, **k: None
            stack.callback(setattr, opt, "step", orig)
    elif fault == "half_batch":
        patch("d_logistic_loss", lambda f: lambda real, fake: f(_half(real), _half(fake)))
        patch("g_nonsaturating_loss", lambda f: lambda fake: f(_half(fake)))
    elif fault == "half_batch_r1":
        patch("r1_penalty", lambda f: lambda logit_fn, real: f(logit_fn, _half(real)))
    elif fault == "half_batch_path":
        def halved_path(f):
            def penalty(*args, **kwargs):
                _, new_mean, lengths = f(*args, **kwargs)
                return (_half(lengths) - new_mean).square().mean(), new_mean, lengths
            return penalty
        patch("path_length_penalty", halved_path)
    elif fault == "half_batch_battery":
        def halved(f):
            def loss(cfg, same, not_same, dist_fn):
                n = max(2, same[0].shape[0] // 4 * 2)
                return f(cfg, [s[:n] for s in same], [_half(s) for s in not_same], dist_fn)
            return loss
        patch("contrastive_loss", halved)
    elif fault == "sign_flip":
        def negate(opt, args, kwargs):
            for grp in opt.param_groups:
                for p in grp["params"]:
                    if p.grad is not None:
                        p.grad.neg_()
        for opt in (trainer.state.g_opt, trainer.state.d_opt):
            stack.callback(opt.register_step_pre_hook(negate).remove)
    elif fault == "drop_battery":
        def dropped(f):
            def losses(*args, **kwargs):
                total, metrics = f(*args, **kwargs)
                return total.detach(), metrics
            return losses
        patch("_attr_losses_for_batch", dropped)
    elif fault is not None:
        raise ValueError(f"unknown fault {fault!r}")
    return stack


@contextlib.contextmanager
def handed(trainer, inputs: train_ref.Inputs, size: int):
    """Within: each of the program's four steps, as ``one_iteration`` calls
    it, takes the benchmark's draws from ``inputs`` (its ``z_list``,
    ``noise``, ``inject_index`` with two z, ``path_noise``) in place of the
    program's own, and the transforms that ADA's ``augment`` samples are
    recorded beside them."""
    from gan_control_torch.trainers import generator_trainer as gt
    from gan_control_torch.training import ada as port_ada

    g = trainer.state.generator

    def wrap(name, fn):
        sig = inspect.signature(fn)

        def step(*args, **kwargs):
            bound = sig.bind(*args, **kwargs)
            a = bound.arguments
            if a.get("arrangement") is not None:
                raise ValueError("the benchmark's cells run no randomised arrangement")
            z = a.get("z_list")
            batch = None if z is None else z[0].shape[0]
            rec = inputs.step(
                name, batch=batch, z_dim=0 if z is None else z[0].shape[1],
                n_z=0 if z is None else len(z),
                noise_shapes=() if z is None else g.noise_shapes(batch), n_latent=g.n_latent,
                image_shape=(batch, size, size, 3) if name == "g_reg_step" else None)
            for k in ("z", "noise", "inject_index", "path_noise"):
                if k in rec:
                    a["z_list" if k == "z" else k] = rec[k]
            return fn(*bound.args, **bound.kwargs)
        return step

    def sampler(kind, fn):
        def sample(*args, **kwargs):
            out = fn(*args, **kwargs)
            if inputs.ada is not None:
                inputs.ada.append((kind, out.detach().clone()))
            return out
        return sample

    saved = [(gt, n, getattr(gt, n)) for n in train_ref.STEPS]
    saved += [(port_ada, "sample_affine", port_ada.sample_affine),
              (port_ada, "sample_color", port_ada.sample_color)]
    try:
        for mod, n, fn in saved:
            setattr(mod, n, sampler(n[len("sample_"):], fn) if mod is port_ada else wrap(n, fn))
        yield inputs
    finally:
        for mod, n, fn in saved:
            setattr(mod, n, fn)
        inputs.ada = None


def _setup(cell: dict, config: dict, seed: int, device):
    """The trainer on the benchmark's weights, the pool of reals and the
    weights on the host (for the reference)."""
    from gan_control_torch.losses.registry import build_attr_losses, distinct_predictors
    from gan_control_torch.trainers import generator_trainer as gt

    tr, tc = cell["traffic"], config["training_config"]
    size, batch = config["model_config"]["size"], tc["batch"]
    weights = build.weights(config, seed, device)
    pool = traffic.uniform_images(seed, tr["pool_batches"], batch, size)
    specs, predictors = build_attr_losses(tc, device=device, seed=seed)
    trainer = gt.GeneratorTrainer(config=config, init_dirs=False, data_loader=itertools.cycle(pool),
                                  device=device, attr_losses=specs, predictors=predictors)
    st = trainer.state
    st.generator.load_state_dict(weights["G"])
    st.g_ema.load_state_dict(weights["G"])
    st.discriminator.load_state_dict(weights["D"])
    for name, net in distinct_predictors(trainer.predictors).items():
        net.load_state_dict(weights["battery"][name])
    if tr.get("ada_p") is not None:
        st.ada_p = torch.tensor(float(tr["ada_p"]), device=device)
    host_weights = {"G": {k: v.cpu() for k, v in weights["G"].items()},
                    "D": {k: v.cpu() for k, v in weights["D"].items()},
                    "battery": {n: {k: v.cpu() for k, v in sd.items()}
                                for n, sd in weights["battery"].items()}}
    return trainer, pool, host_weights


def _checked(trainer, config: dict, seed: int, device, n: int, real_of) -> tuple[dict, object]:
    """Iterations ``0 .. n - 1`` of the program on the benchmark's draws:
    what it produced (losses, gradients, changes) on the host, and the
    draws."""
    st = trainer.state
    inputs = train_ref.Inputs(seed, device)
    metrics = []
    with handed(trainer, inputs, config["model_config"]["size"]), \
            train_ref.recorder(st.g_opt, st.d_opt, st.g_ema,
                               {"G": st.generator, "D": st.discriminator},
                               first_steps(config["training_config"])) as rec:
        for i in range(n):
            metrics.append(trainer.one_iteration(i, real=real_of(i)))
    return train_ref.to_host(rec, metrics), inputs.to("cpu")


# the numbers also taken against the reference in the precision that the
# configuration states (``<name>_bf16``: bf16 in these cells): a cell's
# limits name them where that rounding of its random battery alone moves the
# f32 numbers far (PERF.md)
BF16 = "_bf16"
BF16_NUMBERS = ("adv_loss_gap", "change_gap", "change_median_gap", "d_grad_vec_gap",
                "g_grad_vec_gap", "path_grad_vec_gap", "battery0_gap")


def _follow(config: dict, tr: dict, host_weights: dict, reals: list, inputs, device,
            kind: str) -> dict:
    """The reference's iterations: ``f32`` (TF32 off), ``bf16`` (the
    synthesis, D and battery in the configuration's stated precision) or
    ``control`` (bf16, one precision below it)."""
    mixed = config["model_config"].get("mixed_precision", False)
    if kind == "f32":
        dtype, battery = torch.float32, "float32"
    elif kind == "bf16":
        dtype = torch.bfloat16 if mixed else torch.float32
        battery = config["training_config"].get("predictor_dtype", "float32")
    else:
        dtype, battery = torch.bfloat16, "bfloat16"
    with LowerPrecision() if kind == "control" else contextlib.nullcontext():
        return train_ref.follow(config, host_weights, reals, inputs, device, ada_p=tr.get("ada_p"),
                                dtype=dtype, predictor_dtype=battery,
                                keep=first_steps(config["training_config"]))


def _numbers(config: dict, tr: dict, host_weights: dict, reals: list, inputs, prog: dict,
             device, stand_in: str | None = None, refs: dict | None = None,
             bf16: bool = False) -> dict:
    """The check's numbers of ``prog`` against the reference, or of a
    stand-in in the program's place: ``control``, the reference one
    precision below the configuration's bf16, or ``witness``, the reference
    in the configuration's stated precision. With ``bf16`` also
    :data:`BF16_NUMBERS` against the reference in that precision. ``refs`` caches the references
    followed on these draws. Where the program did not take the cadence's
    draws, every number is infinite."""
    refs = {} if refs is None else refs
    tc = config["training_config"]
    try:
        with build.exact():
            for kind in ("f32", "bf16") if bf16 or stand_in == "witness" else ("f32",):
                if kind not in refs:
                    refs[kind] = _follow(config, tr, host_weights, reals, inputs, device, kind)
            if stand_in == "witness":
                prog = refs["bf16"]
            elif stand_in == "control":
                prog = _follow(config, tr, host_weights, reals, inputs, device, "control")
    except train_ref.MissingInputs as e:
        log(f"the reference cannot follow the program: {e}")
        names = ("r1_gap", "path_gap") + BF16_NUMBERS + tuple(k + BF16 for k in BF16_NUMBERS)
        return {k: float("inf") for k in names}
    numbers = train_numbers(prog, refs["f32"], first_steps(tc), refs["f32"]["battery"])
    if bf16:
        low = train_numbers(prog, refs["bf16"], first_steps(tc), refs["bf16"]["battery"])
        numbers.update({k + BF16: low[k] for k in BF16_NUMBERS})
    return numbers


def _free(trainer) -> None:
    trainer.close()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run(cell: dict, config: dict, seed: int, seconds: float, trace: bool, device,
        fault: str | None = None, control: bool = False) -> dict:
    tr = cell["traffic"]
    config = dict(config, training_config=dict(config["training_config"], seed=seed))
    tc = config["training_config"]
    batch, cadence = tc["batch"], tc["d_reg_every"]
    trainer, pool, host_weights = _setup(cell, config, seed, device)
    st = trainer.state

    checked = tr["checked_iterations"]
    with _faulty(fault, trainer):
        prog, inputs = _checked(trainer, config, seed, device, checked,
                                lambda i: trainer.next_real())

        if device.type == "cuda":
            torch.cuda.synchronize(device)
        setup_end = time.perf_counter()
        log(f"set-up done; iterations 0-{checked - 1} checked")
        cadences = []  # (seconds, kind) per whole cadence
        feed_s = 0.0
        it = cadence
        t0 = time.perf_counter()
        while True:
            k = len(cadences)
            kind = ("traced" if k == 0 else "profile_steps" if k == 1 else "plain") if trace else "plain"
            last = cadences[-1][0] if cadences else 0.0
            elapsed = time.perf_counter() - t0
            if cadences and elapsed + last > seconds and not (trace and k < 3):
                break
            prof = None
            if kind == "traced":
                prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                          torch.profiler.ProfilerActivity.CUDA])
                prof.__enter__()
            trainer.profile_steps = kind == "profile_steps"
            c0 = time.perf_counter()
            with (torch.profiler.record_function("window") if prof else contextlib.nullcontext()):
                for _ in range(cadence):
                    with (torch.profiler.record_function("next_real") if prof
                          else contextlib.nullcontext()):
                        f0 = time.perf_counter()
                        real = trainer.next_real()
                        f1 = time.perf_counter()
                    with (torch.profiler.record_function("one_iteration") if prof
                          else contextlib.nullcontext()):
                        trainer.one_iteration(it, real=real)
                    if kind == "plain":
                        feed_s += f1 - f0
                    it += 1
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
            cadences.append((time.perf_counter() - c0, kind))
            log(f"cadence {k} ({kind}): {cadences[-1][0]:.3f} s")
            trainer.profile_steps = False
            if prof is not None:
                prof.__exit__(None, None, None)
                prof_events = trace_lib.events(prof)
                del prof
    memory_peak = torch.cuda.max_memory_reserved(device) if device.type == "cuda" else 0
    names = {k: [n for n, _ in m.named_parameters()] for k, m in
             (("G", st.generator), ("D", st.discriminator))}
    step_times = {k: list(v) for k, v in trainer.step_times.items()}
    del st
    _free(trainer)
    del trainer

    window_s = sum(s for s, _ in cadences)
    plain = [s for s, kind in cadences if kind == "plain"]
    out = {
        "setup_end": setup_end,
        "e2e": {"train_images_per_s": len(cadences) * cadence * batch / window_s},
        "attempted": len(cadences) * cadence, "failed": 0, "memory_peak": memory_peak,
        "run": {"cadence": cadence, "batch": batch, "plain_cadences": len(plain),
                "plain_s": sum(plain), "feed_s": feed_s, "traced_cadences": 1 if trace else 0,
                "step_times": step_times},
    }
    if trace:
        out["trace"] = trace_lib.reduce(prof_events)

    log(f"window {window_s:.3f} s, {len(cadences)} cadences; reference follows")
    reals = pool[:checked]
    del pool
    refs: dict = {}
    numbers = _numbers(config, tr, host_weights, reals, inputs, prog, device,
                       "control" if control else None, refs,
                       bf16=any(k.endswith(BF16) for k in cell["limits"]))
    out["checks"] = [check(k, numbers[k], limit) for k, limit in cell["limits"].items()]
    out["numbers"] = numbers
    if "f32" in refs and not control:
        out["detail"] = train_detail(prog, refs["f32"], names, first_steps(tc))
    return out


def readings(cell: dict, config: dict, seed: int, device, modes: list[str]) -> dict:
    """The check's numbers of each of ``modes`` (``program``, ``control``,
    ``witness`` or a fault of :data:`FAULTS`) on one seed, from one set-up:
    each mode's iterations start from the same state (the trainer's
    snapshot) on the same reals and draws. No window: the training numbers
    need none."""
    tr = cell["traffic"]
    config = dict(config, training_config=dict(config["training_config"], seed=seed))
    trainer, pool, host_weights = _setup(cell, config, seed, device)
    checked = tr["checked_iterations"]
    reals = pool[:checked]
    on_device = [torch.from_numpy(r).to(device) for r in reals]
    snap = trainer._snapshot()
    progs = {}
    # the program's own iterations come first: the control takes their draws
    for mode in ["program"] + [m for m in modes if m not in ("program", "control", "witness")]:
        trainer._restore(snap)
        with _faulty(None if mode == "program" else mode, trainer):
            progs[mode] = _checked(trainer, config, seed, device, checked, on_device.__getitem__)
    del snap, on_device
    _free(trainer)
    del trainer
    out, cache = {}, []  # (draws, the references followed on them)
    for mode in modes:
        prog, inputs = progs.get(mode, progs["program"])
        refs = next((r for i, r in cache if i.same_as(inputs)), None)
        if refs is None:
            refs = {}
            cache.append((inputs, refs))
        out[mode] = _numbers(config, tr, host_weights, reals, inputs, prog, device,
                             mode if mode in ("control", "witness") else None, refs, bf16=True)
    return out
