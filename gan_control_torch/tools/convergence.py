"""Convergence harness: the port's phase-1 loop LEARNS and DISENTANGLES
(counterpart of the JAX package's ``tools/convergence.py``).

Blob world: 32x32 images of one Gaussian blob whose COLOR and POSITION are
the controlled attributes. The latent is split into two groups (color,
position) exactly like the FFHQ id/orientation/... split, and two
deterministic, differentiable toy "predictors" (intensity-weighted mean
color; intensity centroid) play the role of the frozen battery, closing the
contrastive-disentanglement loop end to end through the port's
``GeneratorTrainer`` (its steps, the kernels, the contrastive criterion,
the group arrangement, the EMA).

What a healthy run shows, at each evaluation, one JSONL record each:

  (a) learning: a pixel-statistics FID proxy (Frechet distance over 8x8
      mean-pooled pixel features) drops from its value at initialisation,
      and the D logistic loss falls below that of a blind D;
  (b) disentanglement: the ratio of toy-feature distances between pairs
      that share a group's sub-latent and pairs that do not collapses from
      ~0.6 toward 0;
  (c) EMA: the EMA generator's proxy improves too and its ratios track the
      live generator's.

    python -m gan_control_torch.tools.convergence [--iters 600]
        [--eval-every 100] [--seed 0] [--random-mode] [--ada] [--bf16]
        [--out PATH] [--device cpu]

The first line of the output names the device (on a card, its name and
power limit as nvidia-smi prints them), then one record per evaluation
with the JAX harness's keys, then ``verdict()``'s line. The blob world, the
toy predictors and the thresholds are the JAX harness's, in numpy and
torch; this module imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch import nn

SIZE = 32
STYLE_DIM = 64
BATCH = 8
# blob std in normalized coords; positions keep the blob inside the frame
BLOB_SIGMA = 0.12
POS_LO, POS_HI = 0.25, 0.75
# evaluation images per sweep, and the generator's chunk
N_EVAL = 256
EVAL_CHUNK = 64

DEFAULT_OUT = Path(__file__).resolve().parents[2] / "build" / "gan_control_torch" / "tools" / "convergence.jsonl"


# ---------------------------------------------------------------------------
# Blob world: the synthetic learnable distribution (numpy, as the JAX tool)
# ---------------------------------------------------------------------------


def render_blobs(colors: np.ndarray, positions: np.ndarray, size: int = SIZE) -> np.ndarray:
    """[N,3] colors in [0,1] + [N,2] positions in [0,1] -> NHWC images in
    [-1,1]: background -1, blob pixels ramp to the (scaled) color."""
    coords = (np.arange(size, dtype=np.float32) + 0.5) / size
    yy, xx = np.meshgrid(coords, coords, indexing="ij")
    d2 = (yy[None] - positions[:, 0, None, None]) ** 2 + (
        xx[None] - positions[:, 1, None, None]
    ) ** 2
    g = np.exp(-d2 / (2.0 * BLOB_SIGMA**2)).astype(np.float32)  # [N,H,W]
    img = -1.0 + 2.0 * g[..., None] * colors[:, None, None, :]
    return img.astype(np.float32)


def sample_blob_params(rng: np.random.Generator, n: int):
    colors = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    positions = rng.uniform(POS_LO, POS_HI, (n, 2)).astype(np.float32)
    return colors, positions


def blob_loader(batch: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    while True:
        colors, positions = sample_blob_params(rng, batch)
        yield render_blobs(colors, positions)


# ---------------------------------------------------------------------------
# Toy predictors: deterministic differentiable attribute extractors
# ---------------------------------------------------------------------------


def _intensity(images: torch.Tensor) -> torch.Tensor:
    """Per-pixel luminance of (img+1)/2, clipped >= 0 (an untrained G emits
    values below -1; negative weights would destabilise the normalisers)."""
    return torch.clamp(torch.mean(images + 1.0, dim=-1) * 0.5, min=0.0)  # [N,H,W]


def color_feature(images: torch.Tensor) -> torch.Tensor:
    """Intensity-weighted mean color, ~ 0.5 * blob color on real blobs
    (the weighting constant cancels between same/not-same distances)."""
    w = _intensity(images)[..., None]  # [N,H,W,1]
    rgb = torch.clamp((images + 1.0) * 0.5, min=0.0)
    return torch.sum(rgb * w, dim=(1, 2)) / (torch.sum(w, dim=(1, 2)) + 1e-4)


def position_feature(images: torch.Tensor) -> torch.Tensor:
    """Intensity centroid in normalized [0,1]^2 coords, = blob position on
    real blobs."""
    w = _intensity(images)  # [N,H,W]
    size = images.shape[1]
    coords = (torch.arange(size, dtype=images.dtype, device=images.device) + 0.5) / size
    denom = torch.sum(w, dim=(1, 2)) + 1e-4
    cy = torch.sum(w * coords[None, :, None], dim=(1, 2)) / denom
    cx = torch.sum(w * coords[None, None, :], dim=(1, 2)) / denom
    return torch.stack([cy, cx], dim=-1)


def make_toy_attr_losses():
    """(specs, predictors): two ``AttributeLossSpec``s closing the
    contrastive loop through the toy predictors (the blob-world stand-ins
    for the FFHQ battery), and their predictor modules (parameterless).
    Thresholds from the blob distribution's feature-distance scales:
    E||c1-c2||^2 ~ 0.125 for the (0.5-scaled) colors, ~0.12 for positions."""
    from gan_control_torch.losses.contrastive import ContrastiveConfig, pairwise_sq_l2
    from gan_control_torch.training.train_step import AttributeLossSpec

    def cfg(lower, upper):
        return ContrastiveConfig(
            intermediate_weights=(),
            last_layer_weight=10.0,
            lower_thres=(),
            upper_thres=(),
            last_lower_thres=lower,
            last_upper_thres=upper,
            focus_on=("same_as_last_layer",),
        )

    specs = (
        AttributeLossSpec(
            name="color_loss",
            group="color",
            cfg=cfg(0.002, 0.05),
            feature_fn=lambda pp, images: [color_feature(images)],
            dist_fn=pairwise_sq_l2,
            pair_dist_fn=pairwise_sq_l2,
        ),
        AttributeLossSpec(
            name="position_loss",
            group="position",
            cfg=cfg(0.002, 0.04),
            feature_fn=lambda pp, images: [position_feature(images)],
            dist_fn=pairwise_sq_l2,
            pair_dist_fn=pairwise_sq_l2,
        ),
    )
    predictors = {"color_loss": nn.Module(), "position_loss": nn.Module()}
    return specs, predictors


def toy_config(iters: int, seed: int = 0, random_mode: bool = False,
               ada: bool = False, bf16: bool = False) -> dict:
    """Tiny blob-world config: 32x32, 2 latent groups, split_fc mapping —
    the FFHQ schema (configs/ffhq.json) shrunk to the blob world.

    ``random_mode``: mini_batch_mode='random' (a fresh group slot placement
    every step, through the masked contrastive path). ``ada``: adaptive
    discriminator augmentation from p=0 with a short ada_length, so that
    the adaptation shows within the run. ``bf16``: the shipped
    mixed-precision plan (bf16 synthesis and D pyramid)."""
    sub_groups = {
        "color": {"place_in_mini_batch": [0, 4], "place_in_latent": [0, 32]},
        "position": {"place_in_mini_batch": [4, 8], "place_in_latent": [32, 64]},
    }
    if random_mode:
        for g in sub_groups.values():
            g["count_in_mini_bach"] = [2, 6]
    return {
        "save_name": "convergence",
        "add_weight_to_name": False,
        "model_config": {
            "vanilla": False,
            "img_channels": 3,
            "split_fc": True,
            "marge_fc": False,
            "latent_size": STYLE_DIM,
            "size": SIZE,
            "n_mlp": 2,
            "channel_multiplier": 0.5,
            "max_channels": 64,
            "g_noise_mode": "normal",
            "mixed_precision": bf16,
        },
        "training_config": {
            "debug": False,
            "iter": iters,
            "start_iter": 0,
            "seed": seed,
            "batch": BATCH,
            "mini_batch": BATCH,
            "mini_batch_mode": "random" if random_mode else "normal",
            "augment": (
                {"enabled": True, "p": 0, "ada_target": 0.6,
                 "ada_length": 5000}
                if ada else {"enabled": False}
            ),
            "sub_groups_dict": sub_groups,
            "r1": 1,
            "d_every": 1,
            "g_reg_every": 4,
            "d_reg_every": 16,
            "lr_g": 0.003,
            "lr_d": 0.003,
            "g_moving_average": 100,
            "path_regularize": 2,
            "path_batch_shrink": 2,
            "mixing": 0,
        },
        "data_config": {"data_set_name": "synthetic", "path": ""},
        "evaluation_config": {
            "fid": {"enabled": False},
            "separability": {"enabled": False},
        },
        "tensorboard_config": {"enabled": False},
        "monitor_config": {"enabled": False},
        "ckpt_config": {"enabled": False, "ckpt": "no_ckpt"},
    }


# ---------------------------------------------------------------------------
# Measurements
# ---------------------------------------------------------------------------


def _pixel_feats(images: np.ndarray) -> np.ndarray:
    """8x8 mean-pooled pixel features (N, 192): the FID-proxy feature space
    (pixel statistics, no learned net)."""
    n, h, w, c = images.shape
    f = images.reshape(n, 8, h // 8, 8, w // 8, c).mean(axis=(2, 4))
    return f.reshape(n, -1).astype(np.float64)


def frechet_pixel_distance(feats_a: np.ndarray, feats_b: np.ndarray) -> float:
    """Frechet distance between Gaussian fits of two pixel-feature sets.
    Untrained blob images have near-constant features, so the covariances
    are routinely degenerate: an unconditional 1e-6 ridge and the real part
    of the square root keep the proxy total (the FID path raises instead).
    The square root is the port's FID's (scipy's ``sqrtm``, else an
    eigendecomposition)."""
    from gan_control_torch.evaluation.fid import _sqrtm_psd

    mu_a, mu_b = feats_a.mean(0), feats_b.mean(0)
    cov_a = np.cov(feats_a, rowvar=False) + 1e-6 * np.eye(feats_a.shape[1])
    cov_b = np.cov(feats_b, rowvar=False) + 1e-6 * np.eye(feats_b.shape[1])
    covmean = _sqrtm_psd(cov_a @ cov_b)
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    d2 = np.sum((mu_a - mu_b) ** 2) + np.trace(cov_a + cov_b - 2.0 * covmean)
    return float(max(d2, 0.0))


GROUPS = (("color", (0, 32), color_feature), ("position", (32, 64), position_feature))


@dataclasses.dataclass
class Evaluator:
    """Fixed evaluation latents and real features, reused across
    evaluations. Each chunk of a sweep draws its injection noise from a
    ``torch.Generator`` seeded with its offset, so every sweep of the same
    parameters sees the same noise."""

    device: torch.device
    n_eval: int = N_EVAL

    def __post_init__(self):
        rng = np.random.default_rng(123)
        colors, positions = sample_blob_params(rng, self.n_eval)
        self.real_feats = _pixel_feats(render_blobs(colors, positions))
        # paired latents: zB shares zA's group sub-latent for the "same"
        # leg and keeps its own draw for the "not-same" leg
        self.zA = rng.standard_normal((self.n_eval, STYLE_DIM)).astype(np.float32)
        self.zB = rng.standard_normal((self.n_eval, STYLE_DIM)).astype(np.float32)

    @torch.no_grad()
    def _gen(self, g: nn.Module, z: np.ndarray) -> torch.Tensor:
        out = []
        for s in range(0, z.shape[0], EVAL_CHUNK):
            gen = torch.Generator(device=self.device).manual_seed(99 + s)
            zc = torch.from_numpy(z[s : s + EVAL_CHUNK]).to(self.device)
            img, _ = g([zc], generator=gen)
            out.append(img.float())
        return torch.cat(out)

    @torch.no_grad()
    def ratios(self, g: nn.Module, imgs_a: torch.Tensor | None = None) -> dict:
        """Same/not-same toy-feature distance ratios per group."""
        if imgs_a is None:
            imgs_a = self._gen(g, self.zA)
        imgs_not = self._gen(g, self.zB)  # group-independent
        res = {}
        for gname, (lo, hi), feat in GROUPS:
            z_same = self.zB.copy()
            z_same[:, lo:hi] = self.zA[:, lo:hi]
            imgs_same = self._gen(g, z_same)
            fa, fs, fn_ = (feat(x).double().cpu().numpy() for x in (imgs_a, imgs_same, imgs_not))
            d_same = float(np.mean(np.sum((fa - fs) ** 2, -1)))
            d_not = float(np.mean(np.sum((fa - fn_) ** 2, -1)))
            res[f"{gname}_same_dist"] = d_same
            res[f"{gname}_not_same_dist"] = d_not
            res[f"{gname}_ratio"] = d_same / max(d_not, 1e-9)
        return res

    def fid_proxy(self, g: nn.Module, imgs: torch.Tensor | None = None) -> float:
        if imgs is None:
            imgs = self._gen(g, self.zA)
        return frechet_pixel_distance(self.real_feats, _pixel_feats(imgs.cpu().numpy()))

    def checkpoint(self, state, it: int, d_loss_recent: float | None) -> dict:
        """One record: both generators' FID proxies and ratios (one zA sweep
        per generator, shared by the two)."""
        imgs_live = self._gen(state.generator, self.zA)
        imgs_ema = self._gen(state.g_ema, self.zA)
        rec = {"iter": it,
               "fid_proxy": self.fid_proxy(state.generator, imgs_live),
               "ema_fid_proxy": self.fid_proxy(state.g_ema, imgs_ema)}
        rec.update(self.ratios(state.generator, imgs_live))
        ema = self.ratios(state.g_ema, imgs_ema)
        rec.update({f"ema_{k}": v for k, v in ema.items()})
        if d_loss_recent is not None:
            rec["d_loss_recent"] = d_loss_recent
        return rec


def device_line(device: torch.device) -> dict:
    """The output's first line: the device, and on a card its name and
    power limit as nvidia-smi prints them."""
    rec = {"device": str(device), "torch": torch.__version__}
    if device.type == "cuda":
        rec["kind"] = torch.cuda.get_device_name(device)
        rec["tf32"] = {"cudnn": torch.backends.cudnn.allow_tf32,
                       "matmul": torch.backends.cuda.matmul.allow_tf32}
        try:
            rec["nvidia_smi"] = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
        except (OSError, subprocess.SubprocessError) as e:
            rec["nvidia_smi"] = f"not available: {e}"
    return rec


def emitter(out_path, records: list):
    """(emit, close): ``emit(rec)`` appends ``rec`` to ``records``, prints
    it and writes it as a line of ``out_path`` (floats rounded to 5
    places)."""
    out = None
    if out_path:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        out = open(out_path, "w")

    def emit(rec: dict, keep: bool = True) -> None:
        if keep:
            records.append(rec)
        line = json.dumps({k: round(v, 5) if isinstance(v, float) else v for k, v in rec.items()})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    return emit, (out.close if out else (lambda: None))


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------


def make_trainer(iters: int, seed: int, device, random_mode: bool = False, ada: bool = False,
                 bf16: bool = False):
    """The port's ``GeneratorTrainer`` on the blob world with the toy
    battery (no results directory)."""
    from gan_control_torch.trainers.generator_trainer import GeneratorTrainer

    specs, predictors = make_toy_attr_losses()
    return GeneratorTrainer(
        config=toy_config(iters, seed, random_mode=random_mode, ada=ada, bf16=bf16),
        init_dirs=False,
        data_loader=blob_loader(BATCH, seed=seed + 1),
        device=device,
        attr_losses=specs,
        predictors=predictors,
    )


def run(iters: int = 600, eval_every: int = 100, seed: int = 0,
        out_path: str | Path | None = None, random_mode: bool = False,
        ada: bool = False, bf16: bool = False, device: str | torch.device | None = None,
        n_eval: int = N_EVAL) -> list[dict]:
    """Train the blob world through the port's ``GeneratorTrainer`` on
    ``device`` (CUDA unless given); returns the evaluation records (first =
    initialisation, last = final), each over ``n_eval`` images per sweep.
    ``out_path`` gets the device line, the records and then whatever the
    caller appends."""
    from gan_control_torch.utils.device import resolve_device

    device = resolve_device(device)
    trainer = make_trainer(iters, seed, device, random_mode, ada, bf16)
    ev = Evaluator(device, n_eval)
    records: list[dict] = []
    emit, close = emitter(out_path, records)
    emit(device_line(device), keep=False)
    try:
        emit(ev.checkpoint(trainer.state, 0, None))
        d_losses: list[torch.Tensor] = []
        t0 = time.time()
        for i in range(iters):
            metrics = trainer.one_iteration(i)
            d_losses.append(metrics["d_loss"].detach())
            if (i + 1) % eval_every == 0:
                recent = float(torch.stack(d_losses[-min(50, len(d_losses)):]).float().mean())
                rec = ev.checkpoint(trainer.state, i + 1, recent)
                rec["seconds"] = round(time.time() - t0, 1)
                if "ada_p" in metrics:
                    rec["ada_p"] = float(metrics["ada_p"])
                emit(rec)
    finally:
        close()
        trainer.close()
    return records


def verdict(records: list[dict]) -> dict:
    """The convergence claims, as booleans (the JAX harness's criteria and
    thresholds)."""
    first, last = records[0], records[-1]
    d_first = records[1].get("d_loss_recent") if len(records) > 1 else None
    d_last = last.get("d_loss_recent")
    init_untrained_d = 2.0 * float(np.log(2.0))  # logistic loss of a blind D
    ada = (
        {"ada_p_final": round(last["ada_p"], 4), "ada_adapted": last["ada_p"] > 0}
        if "ada_p" in last
        else {}
    )
    return ada | {
        "fid_proxy_improved": last["fid_proxy"] < 0.5 * first["fid_proxy"],
        "ema_fid_proxy_improved": last["ema_fid_proxy"] < 0.5 * first["ema_fid_proxy"],
        "d_below_untrained": d_last is not None and d_last < init_untrained_d,
        "color_disentangled": last["color_ratio"] < 0.5 * max(first["color_ratio"], 1e-9)
        and last["color_ratio"] < 0.5,
        "position_disentangled": last["position_ratio"]
        < 0.5 * max(first["position_ratio"], 1e-9)
        and last["position_ratio"] < 0.5,
        "ema_tracks": last["ema_color_ratio"] < 0.5
        and last["ema_position_ratio"] < 0.5,
        "init_fid_proxy": round(first["fid_proxy"], 4),
        "final_fid_proxy": round(last["fid_proxy"], 4),
        "d_loss_first_window": None if d_first is None else round(d_first, 4),
        "d_loss_last_window": None if d_last is None else round(d_last, 4),
    }


def passed(v: dict) -> bool:
    return all(bool(x) for x in v.values() if isinstance(x, bool))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=600)
    ap.add_argument("--eval-every", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--random-mode", action="store_true",
                    help="mini_batch_mode='random' (a fresh arrangement every step)")
    ap.add_argument("--ada", action="store_true",
                    help="adaptive discriminator augmentation (short ada_length)")
    ap.add_argument("--bf16", action="store_true", help="the shipped mixed-precision plan")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--device", default=None, help="CUDA unless given (e.g. cpu)")
    args = ap.parse_args(argv)

    records = run(args.iters, args.eval_every, args.seed, args.out, random_mode=args.random_mode,
                  ada=args.ada, bf16=args.bf16, device=args.device)
    v = verdict(records)
    if args.ada and "ada_adapted" not in v:
        v["ada_adapted"] = False  # no record carried ada_p (iters < eval-every)
    print(json.dumps(v), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(v) + "\n")
    return 0 if passed(v) else 1


if __name__ == "__main__":
    sys.exit(main())
