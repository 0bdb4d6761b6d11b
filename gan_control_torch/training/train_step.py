"""The four phase-1 train steps (port of
``gan_control_tpu/training/train_step.py``):

  - ``d_step``: D logistic loss on G(z) (iid z, no arrangement, G under
    ``no_grad``) against the reals; the gradient is scaled as the reference
    scales it, ``mean_loss * num_mini / mini_batch`` (each mini-batch chunk
    divided by its size and accumulated). With ``augment_fn`` (ADA) the
    fakes and then the reals are augmented at ``state.ada_p``; in ADA mode
    (``ada_enabled`` and no fixed ``ada_p_fixed``) ``ada_p`` then adapts
    toward ``ada_target`` from ``r_t = mean(sign(real logits))``.
  - ``d_reg_step``: R1 on the unaugmented reals, weighted
    ``r1 / 2 * d_reg_every``.
  - ``g_step``: non-saturating loss of D on G(z) (augmented by
    ``augment_fn`` when given; the battery reads G(z) unaugmented), z
    arranged per mini-batch
    chunk by ``re_arrange_z`` (or, in the randomized mini-batch mode, by the
    step's ``arrangement``: one z, no mixing), plus the contrastive
    attribute losses of the frozen predictor battery (``attr_losses``, from
    ``losses.registry.build_attr_losses``); then the EMA. Under the
    ``same_for_same_id`` noise mode, and when the caller passes no
    ``noise``, the injection noise is drawn from ``state.rng`` and arranged
    per chunk so that the noise group's pairs share it.
  - ``g_reg_step``: path length on the caller's (shrunk) batch, with style
    mixing when given two z, weighted ``path_regularize * g_reg_every``; then
    the EMA delta correction ``ema += (1 - d) * (p_new - p_old)``, so the EMA
    lands on ``d * ema + (1 - d) * p_post`` once per iteration.

Each step updates the state in place and returns its metrics as tensors
(no host sync). The parameters' ``.grad`` hold the step's gradients after it
returns. Every random input a step draws can be passed explicitly
(injection ``noise`` per layer, ``inject_index``, the path-length
``path_noise``); otherwise it comes from ``state.rng``.

The attribute losses: the G's images go to the battery in
``predictor_dtype`` (bf16 under int8 storage, the weights dequantised once
per step); each predictor's features come back to f32 before any
distance (the thresholds were calibrated on f32 distances); each mini-batch
chunk is split into its group's rows and the rest (with an
``arrangement``: the criterion reads its pair masks), and the losses are
the mean over the chunks. Specs with one ``share_key`` (the recon-3d sub-losses)
read one forward of their shared net. With ``remat_predictors`` each loss
runs under ``torch.utils.checkpoint``, so the backward re-runs one net at a
time instead of holding every net's activations. The predictors are frozen:
their parameters take no gradient, the image does. On CUDA, without
remat, an arrangement or data parallelism, the battery's forward, criterion
and image gradient replay from one CUDA graph (``losses/battery_graph.py``).

The memory plan: with ``remat_reg`` the two regularizer steps run G and D
with ``remat`` on (each StyledConv of G, each ResBlock of D recomputed in
the backward: the same parameters and draws, another backward schedule, as
the JAX steps run on ``generator.clone(remat=True)``) and put each module's
flag back afterwards, also when the step raises; ``d_step`` and ``g_step``
run the modules as they are set (``model_config.remat`` sets both in the
factory). Under ``remat`` G draws its injection noise from ``state.rng``
before the synthesis, in the layers' order, so the reg steps draw the same
noise, mixing index and path-length noise under either plan.

Each optimizer step gives a zero gradient to every parameter the loss did
not reach, as optax updates every leaf, so all parameters share one Adam
step count (the checkpoint's optax ``count``). R1 and the path length
never augment, as the reference's regularisation steps do not.

Spans (``utils/tracing.py``, recorded while a ``torch.profiler`` runs):
``synthesis`` (each G synthesis), ``discriminator`` (each D forward),
``ada`` (each ``augment_fn`` call), ``battery`` (the whole
``_attr_losses_for_batch`` call) and ``battery.<loss or share_key>`` (each
net's forward, inside the function that ``checkpoint`` runs, so that the
recompute in the backward opens it again, under ``backward``; on the eager
path and at a capture only, not inside a replay of the battery's CUDA
graph, ``losses/battery_graph.py``),
``backward`` (each ``.backward()``), ``optimizer`` (``state.py``) and
``ema`` (the EMA update; in ``g_reg_step`` the parameters' copy before the
step and the delta after it).

``augment_fn`` has the JAX hook's signature, ``(images, p, generator) ->
images`` (``training.ada.augment``), its draws from ``state.rng``.

Data parallelism: under a process group (``utils/multihost.py``) each rank
passes its contiguous rows of the global batch (reals, z, explicit noise
and path noise) and holds the same state; every step runs inside
``utils.collectives.sharded_batch``, so it computes what one process
computes at the global batch: draws at the global batch (each rank keeps
its rows), the minibatch stddev, the arrangement of z and of the
``same_for_same_id`` noise, the battery's criterion (on the predictors'
gathered features; no rank runs a predictor on another's rows) and the
path-length mean over the gathered rows, ``r_t`` and ``ada_p``'s step from
the global batch, the gradients averaged over ranks before each optimizer
step, and the metrics as global means, the same on every rank.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Mapping, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from gan_control_torch.latent.groups import (
    Arrangement,
    GroupSpec,
    apply_arrangement_noise,
    apply_arrangement_z,
    re_arrange_inject_noise,
    re_arrange_z,
    same_not_same_split,
)
from gan_control_torch.losses import battery_graph
from gan_control_torch.losses.contrastive import (
    ContrastiveConfig,
    contrastive_loss,
    contrastive_loss_masked,
)
from gan_control_torch.losses.int8_storage import Int8Battery
from gan_control_torch.training.gan_losses import (
    d_logistic_loss,
    g_nonsaturating_loss,
    path_length_penalty,
    r1_penalty,
)
from gan_control_torch.training.ada import ada_p_update
from gan_control_torch.training.state import GANTrainState, ema_decay, ema_update, optimizer_step
from gan_control_torch.utils import collectives, tracing
from gan_control_torch.utils.precision import battery_dtype


@dataclasses.dataclass(frozen=True)
class AttributeLossSpec:
    """One enabled contrastive loss (one JSON loss block).

    feature_fn: (predictor module, NHWC images in [-1, 1]) -> list of
      per-layer features, the criterion's embedding last.
    dist_fn: last-layer features -> [N, N] distance matrix.
    pair_dist_fn: (signatures, queries) -> [N, M], the same criterion
      between two sets (separability).
    share_key: specs with one key (the recon-3d sub-losses) run
      ``shared_forward_fn`` once per step and slice it with ``extract_fn``;
      ``feature_fn`` stays the standalone path.
    """

    name: str
    group: str
    cfg: ContrastiveConfig
    feature_fn: Callable[[nn.Module, torch.Tensor], Sequence[torch.Tensor]]
    dist_fn: Callable[[torch.Tensor], torch.Tensor]
    pair_dist_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] | None = None
    share_key: str | None = None
    shared_forward_fn: Callable[[nn.Module, torch.Tensor], Any] | None = None
    extract_fn: Callable[[Any], Sequence[torch.Tensor]] | None = None


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    """Static hyper-parameters of the train steps (training_config schema)."""

    batch: int
    mini_batch: int
    r1: float = 1.0
    d_reg_every: int = 16
    g_reg_every: int = 4
    path_regularize: float = 2.0
    path_batch_shrink: int = 2
    g_moving_average: float = 10000.0
    mixing: float = 0.0
    vanilla: bool = False
    style_dim: int = 512
    ada_target: float = 0.6
    ada_length: float = 500_000.0
    ada_enabled: bool = False
    # the configured augment['p']: 0 adapts p toward ada_target, a positive
    # value is a fixed strength, never adapted
    ada_p_fixed: float = 0.0
    # re-run each frozen predictor in the backward instead of holding every
    # predictor's activations at once
    remat_predictors: bool = True
    # the battery's storage dtype: "float32" (the reference), "bfloat16",
    # "float16" or "int8" (dequantised to bf16 once per g_step)
    predictor_dtype: str = "float32"
    # run d_reg_step and g_reg_step on rematerialised G and D
    remat_reg: bool = False

    @property
    def num_mini(self) -> int:
        return max(1, self.batch // self.mini_batch)


def _per_chunk(cfg: TrainStepConfig, tensors: Sequence[torch.Tensor], fn) -> list[torch.Tensor]:
    """``fn`` (a list of tensors -> a list of tensors) on each mini-batch
    chunk of ``tensors``, the chunks concatenated again."""
    mb = cfg.mini_batch
    chunks = [fn([t[k * mb : (k + 1) * mb] for t in tensors]) for k in range(cfg.num_mini)]
    return [torch.cat([c[i] for c in chunks], dim=0) for i in range(len(chunks[0]))]


def _gen_images(state: GANTrainState, cfg: TrainStepConfig, spec: GroupSpec | None,
                z_list, noise, inject_index, arrange: bool,
                arrangement: Arrangement | None = None):
    styles = list(z_list)
    arranged = arrange and not cfg.vanilla and spec is not None
    if arranged:
        # the arrangement pairs rows across the mini-batch chunk: it runs on
        # the global batch of z, and the rank keeps its rows
        styles = [collectives.gather_batch(z) for z in styles]
        if arrangement is not None:
            styles = _per_chunk(cfg, styles[:1], lambda c: [apply_arrangement_z(arrangement, c[0])])
        else:
            styles = _per_chunk(cfg, styles, lambda c: re_arrange_z(spec, c))
        styles = [collectives.own_rows(z) for z in styles]
    g = state.generator
    if arranged and noise is None and g.noise_mode == "same_for_same_id":
        rng = state.rng
        noise = [torch.randn(s, generator=rng, device=rng.device).to(styles[0].device)
                 for s in g.noise_shapes(cfg.batch)]
        noise = _per_chunk(cfg, noise, lambda c: apply_arrangement_noise(arrangement, c)
                           if arrangement is not None else re_arrange_inject_noise(spec, c))
        noise = [collectives.own_rows(n) for n in noise]
    return g(styles, return_latents=True, inject_index=inject_index, noise=noise,
             generator=state.rng)


AugmentFn = Callable[[torch.Tensor, torch.Tensor, torch.Generator], torch.Tensor]


def _synthesis(*args, **kwargs):
    with tracing.span("synthesis"):
        return _gen_images(*args, **kwargs)


def _discriminator(d: nn.Module, img: torch.Tensor):
    with tracing.span("discriminator"):
        return d(img)


def _augment(augment_fn: AugmentFn, img: torch.Tensor, state: GANTrainState) -> torch.Tensor:
    with tracing.span("ada"):
        return augment_fn(img, state.ada_p, state.rng)


def _backward(loss: torch.Tensor) -> None:
    with tracing.span(tracing.BACKWARD):
        loss.backward()


@collectives.sharded_batch()
def d_step(state: GANTrainState, cfg: TrainStepConfig, spec: GroupSpec | None,
           real_img: torch.Tensor, z_list: Sequence[torch.Tensor], *,
           noise=None, inject_index: int | None = None,
           augment_fn: AugmentFn | None = None) -> dict:
    with torch.no_grad():
        fake_img, _ = _synthesis(state, cfg, spec, z_list, noise, inject_index, arrange=False)
        if augment_fn is not None:
            fake_img = _augment(augment_fn, fake_img, state)
            real_img = _augment(augment_fn, real_img, state)
    d = state.discriminator
    fake_pred, _ = _discriminator(d, fake_img)
    real_pred, _ = _discriminator(d, real_img)
    loss = d_logistic_loss(real_pred, fake_pred)
    state.d_opt.zero_grad(set_to_none=True)
    _backward(loss * (cfg.num_mini / cfg.mini_batch))
    optimizer_step(state.d_opt)
    metrics = collectives.mean_metrics({
        "d_loss": loss.detach(),
        "real_score": real_pred.detach().mean(),
        "fake_score": fake_pred.detach().mean(),
        "r_t": torch.sign(real_pred.detach()).mean(),
    })
    if cfg.ada_enabled and cfg.ada_p_fixed == 0:
        n_pred = collectives.global_batch(real_img.shape[0])[0]
        state.ada_p = ada_p_update(state.ada_p, metrics["r_t"], cfg.ada_target, n_pred,
                                   cfg.ada_length)
        metrics["ada_p"] = state.ada_p
    return metrics


@contextlib.contextmanager
def _rematerialised(module: nn.Module, on: bool):
    """``module.remat`` on inside the context when ``on``; afterwards, also
    after an exception, the flag it had."""
    before = module.remat
    module.remat = before or on
    try:
        yield module
    finally:
        module.remat = before


@collectives.sharded_batch()
def d_reg_step(state: GANTrainState, cfg: TrainStepConfig, real_img: torch.Tensor) -> dict:
    with _rematerialised(state.discriminator, cfg.remat_reg) as d:
        r1 = r1_penalty(lambda x: _discriminator(d, x)[0], real_img)
        state.d_opt.zero_grad(set_to_none=True)
        _backward(cfg.r1 / 2.0 * r1 * cfg.d_reg_every)
    optimizer_step(state.d_opt)
    return collectives.mean_metrics({"d_r1_loss": r1.detach()})


@contextlib.contextmanager
def _frozen(module: nn.Module):
    """``module``'s parameters take no gradient inside the context."""
    module.requires_grad_(False)
    try:
        yield
    finally:
        module.requires_grad_(True)


def _attr_losses_for_batch(
    attr_losses: Sequence[AttributeLossSpec],
    spec: GroupSpec,
    predictors: Mapping[str, nn.Module],
    images: torch.Tensor,
    num_mini: int,
    remat: bool = False,
    dtype: torch.dtype = torch.float32,
    arrangement: Arrangement | None = None,
) -> tuple[torch.Tensor, dict]:
    """Sum of the contrastive losses over ``images`` (NHWC), each the mean
    over the ``num_mini`` mini-batch chunks, and each loss as a metric
    ``g_<name>``. With ``arrangement`` (its tables as tensors on the images'
    device) the pairs come from its masks instead of the spec's slots.
    ``dtype`` is the battery's storage dtype (the images are cast to it;
    float16 and bf16 batteries run in it): under int8 ``predictors`` is
    the ``Int8Battery`` of ``cast_predictor_params``, dequantised here to
    bf16 in one launch, before any net and outside the checkpoints (as the
    JAX step dequantises before it casts the images), and the nets and the
    images run in bf16.
    The criterion reads the features of the global batch: inside
    ``collectives.sharded_batch`` each layer it weighs is gathered over the
    ranks (a layer of weight 0, which it skips, stands in as zeros).
    Where ``losses.battery_graph.engages`` (on CUDA, a float storage, no
    ``remat``, no ``arrangement``, one process), the battery runs from its
    CUDA graph from its third call on: the same losses, their metrics
    without a gradient."""
    if dtype == torch.int8:
        if not isinstance(predictors, Int8Battery):
            raise TypeError("int8 storage runs on the battery of cast_predictor_params(predictors, 'int8')")
        predictors = predictors.nets(torch.bfloat16)
    images = images.to(torch.bfloat16 if dtype == torch.int8 else dtype)

    criterion = contrastive_loss

    def battery(x):
        return _battery_losses(attr_losses, spec, predictors, x, num_mini, remat, arrangement,
                               criterion)

    if attr_losses and battery_graph.engages(images, dtype, remat, arrangement):
        extra = (tuple(map(id, attr_losses)), id(spec), id(predictors), num_mini, id(criterion))
        return battery_graph.run(attr_losses, predictors, images, extra, battery)
    tracing.count("battery_eager")
    return battery(images)


def _battery_losses(attr_losses, spec, predictors, images, num_mini, remat, arrangement,
                    criterion):
    """:func:`_attr_losses_for_batch` on images of the battery's dtype,
    eagerly, with ``criterion`` as the spec-driven contrastive loss."""
    n_rows = collectives.global_batch(images.shape[0])[0]
    mb = n_rows // num_mini

    def global_features(feats, al):
        if not collectives.sharded():
            return feats
        return [collectives.gather_batch(f) if w else f.new_zeros((n_rows, 1))
                for f, w in zip(feats, al.cfg.weights)]

    def chunked_contrastive(feats, al):
        feats = global_features(feats, al)
        loss_al = torch.zeros((), dtype=torch.float32, device=images.device)
        for k in range(num_mini):
            chunk = [f[k * mb : (k + 1) * mb].float() for f in feats]
            if arrangement is not None:
                loss_al = loss_al + contrastive_loss_masked(
                    al.cfg, chunk, al.dist_fn, arrangement.same_pair_masks[al.group],
                    arrangement.not_same_pair_masks[al.group])
                continue
            same, not_same = zip(*(same_not_same_split(spec, f, al.group) for f in chunk))
            loss_al = loss_al + criterion(al.cfg, same, not_same, al.dist_fn)
        return loss_al / num_mini

    def run(fn, *args):
        return checkpoint(fn, *args, use_reentrant=False) if remat else fn(*args)

    def net(name, fn):
        # the span opens inside the function that checkpoint runs, so that
        # its recompute in the backward opens it again
        def forward(*args):
            with tracing.span(f"battery.{name}"):
                return fn(*args)
        return forward

    shared: dict[str, Any] = {}
    for al in attr_losses:
        if al.share_key is not None and al.share_key not in shared:
            shared[al.share_key] = run(net(al.share_key, al.shared_forward_fn), predictors[al.name],
                                       images)

    total = torch.zeros((), dtype=torch.float32, device=images.device)
    metrics = {}
    for al in attr_losses:
        if al.share_key is not None:
            loss_al = chunked_contrastive(al.extract_fn(shared[al.share_key]), al)
        elif collectives.sharded():
            # the gather stays outside the checkpoint, whose recompute in
            # the backward would issue it again
            loss_al = chunked_contrastive(run(net(al.name, al.feature_fn), predictors[al.name],
                                              images), al)
        else:
            loss_al = run(lambda pp, imgs, al=al: chunked_contrastive(
                net(al.name, al.feature_fn)(pp, imgs), al), predictors[al.name], images)
        metrics[f"g_{al.name}"] = loss_al
        total = total + loss_al
    return total, metrics


@collectives.sharded_batch()
def g_step(state: GANTrainState, cfg: TrainStepConfig, spec: GroupSpec | None,
           z_list: Sequence[torch.Tensor], *, noise=None,
           inject_index: int | None = None,
           attr_losses: Sequence[AttributeLossSpec] = (),
           predictors: Mapping[str, nn.Module] | None = None,
           arrangement: Arrangement | None = None,
           augment_fn: AugmentFn | None = None) -> dict:
    """The adversarial loss (on the images augmented by ``augment_fn`` when
    given) plus, with ``attr_losses``, the contrastive losses of the frozen
    ``predictors`` (loss name -> module) on the unaugmented images;
    ``g_loss`` is the total. ``arrangement``: the randomized mini-batch
    mode's placement for this step (numpy or tensors), applied to every
    chunk."""
    if arrangement is not None:
        arrangement = arrangement.to(next(state.generator.parameters()).device)
    with _frozen(state.discriminator):
        img, _ = _synthesis(state, cfg, spec, z_list, noise, inject_index, arrange=True,
                            arrangement=arrangement)
        d_in = img if augment_fn is None else _augment(augment_fn, img, state)
        fake_pred, _ = _discriminator(state.discriminator, d_in)
        adv = g_nonsaturating_loss(fake_pred)
        total, metrics = adv, {"g_adv_loss": adv.detach()}
        if attr_losses:
            with tracing.span("battery"):
                attr_total, attr_metrics = _attr_losses_for_batch(
                    attr_losses, spec, predictors, img, cfg.num_mini, remat=cfg.remat_predictors,
                    dtype=battery_dtype(cfg.predictor_dtype), arrangement=arrangement)
            total = total + attr_total
            metrics.update({k: v.detach() for k, v in attr_metrics.items()})
        state.g_opt.zero_grad(set_to_none=True)
        _backward(total)
    optimizer_step(state.g_opt)
    with tracing.span("ema"):
        ema_update(state.g_ema, state.generator, ema_decay(cfg.batch, cfg.g_moving_average))
    state.step += 1
    metrics["g_loss"] = total.detach()
    return collectives.mean_metrics(metrics)


@collectives.sharded_batch()
def g_reg_step(state: GANTrainState, cfg: TrainStepConfig, z_list: Sequence[torch.Tensor], *,
               noise=None, inject_index: int | None = None,
               path_noise: torch.Tensor | None = None) -> dict:
    g = state.generator
    if len(z_list) > 1 and inject_index is None:
        inject_index = int(torch.randint(1, g.n_latent, (), generator=state.rng,
                                         device=state.rng.device))
    with _rematerialised(g, cfg.remat_reg):
        w_list = [g.map_latent(z) for z in z_list]
        if len(w_list) > 1:
            layer = torch.arange(g.n_latent, device=w_list[0].device)[None, :, None]
            latent = torch.where(layer < inject_index, w_list[0][:, None, :], w_list[1][:, None, :])
        else:
            latent = w_list[0][:, None, :].expand(-1, g.n_latent, -1)

        def synth(lat):
            with tracing.span("synthesis"):
                img, _ = g([lat], input_is_latent=True, noise=noise, generator=state.rng)
            # the path-length sum runs over ~1e7 terms: f32, whatever the synthesis type
            return img.float()

        penalty, new_mean, path_lengths = path_length_penalty(
            synth, latent, path_noise, state.mean_path_length, generator=state.rng)
        with tracing.span("ema"):
            before = [p.detach().clone() for p in g.parameters()]
        state.g_opt.zero_grad(set_to_none=True)
        _backward(cfg.path_regularize * cfg.g_reg_every * penalty)
    optimizer_step(state.g_opt)
    one_minus_d = 1.0 - ema_decay(cfg.batch, cfg.g_moving_average)
    with torch.no_grad(), tracing.span("ema"):
        for e, p, p_old in zip(state.g_ema.parameters(), g.parameters(), before):
            e.add_(p - p_old, alpha=one_minus_d)
    state.mean_path_length = new_mean
    return collectives.mean_metrics({
        "g_path_loss": penalty.detach(),
        "g_path_length": path_lengths.detach().mean(),
        "g_mean_path_length": new_mean,
    })
