"""FID: InceptionV3 feature statistics and the Fréchet distance (port of
``gan_control_tpu/evaluation/fid.py``).

  - :func:`make_feature_fn`: [0, 1] NHWC images -> [B, 2048] pool3
    features, in f32 at "highest" (TF32 off unless
    ``GANCTL_PREDICTOR_PRECISION`` says otherwise), whatever precision the
    training battery runs at;
  - :func:`make_gen_feature_fn`: one FID chunk on one device: z (drawn
    from a ``torch.Generator`` or passed in) -> G -> ``img * 0.5 + 0.5``,
    NOT clipped (the reference feeds the raw G output to Inception; a clip
    would change the FID) -> features. The images stay on the device;
  - :func:`compute_stats`, :func:`frechet_distance` (float64 on the host,
    ``scipy.linalg.sqrtm``, an ``eps * I`` retry when the product is
    singular, a raise on a large imaginary part), the ``{'mean', 'cov'}``
    statistics pickle, and :func:`evaluate_fid`.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Callable, Iterable

import numpy as np
import torch

from gan_control_torch.utils.precision import predictor_precision_ctx


def make_feature_fn(model) -> Callable[[torch.Tensor], torch.Tensor]:
    """images ([0, 1] NHWC, on the model's device) -> [B, 2048] f32."""

    @torch.no_grad()
    def run(images: torch.Tensor) -> torch.Tensor:
        with predictor_precision_ctx():
            return model(images.float())

    return run


def make_gen_feature_fn(generator, inception, batch: int, style_dim: int = 512):
    """``run(gen=None, z=None, noise=None) -> [batch, 2048]``: features of
    ``batch`` images of ``generator``. z is ``z`` or drawn from ``gen`` (a
    ``torch.Generator`` on the G's device), then the injection noise is
    ``noise`` or drawn from ``gen``. ``run.batch`` is the chunk."""
    features = make_feature_fn(inception)

    @torch.no_grad()
    def run(gen: torch.Generator | None = None, z: torch.Tensor | None = None,
            noise=None) -> torch.Tensor:
        if z is None:
            device = gen.device if gen is not None else next(generator.parameters()).device
            z = torch.randn((batch, style_dim), generator=gen, device=device)
        img, _ = generator([z], noise=noise, generator=gen)
        return features(img.float() * 0.5 + 0.5)

    run.batch = batch
    return run


def compute_stats(features) -> tuple[np.ndarray, np.ndarray]:
    """(mean [D], cov [D, D]) in float64."""
    f = np.asarray(features, np.float64)
    return f.mean(axis=0), np.cov(f, rowvar=False)


def _sqrtm_psd(a: np.ndarray) -> np.ndarray:
    """Matrix square root: ``scipy.linalg.sqrtm`` (pytorch-fid's), complex
    results kept so that the caller can check the imaginary part; without
    scipy the symmetric eigendecomposition. (``sqrtm`` is called without
    ``disp``, which SciPy 1.18 removed.)"""
    try:
        from scipy import linalg

        return linalg.sqrtm(a)
    except ImportError:
        w, v = np.linalg.eigh((a + a.T) / 2)
        w = np.clip(w, 0, None)
        return (v * np.sqrt(w)) @ v.T


def frechet_distance(mu1, cov1, mu2, cov2, eps: float = 1e-6) -> float:
    """||mu1 - mu2||^2 + Tr(C1 + C2 - 2 sqrt(C1 C2)) in float64. A
    non-finite square root is retried on ``(C1 + eps I)(C2 + eps I)``; an
    imaginary diagonal above 1e-3 raises (an underestimated FID would be
    saved as the best checkpoint)."""
    mu1, mu2 = np.asarray(mu1, np.float64), np.asarray(mu2, np.float64)
    cov1, cov2 = np.asarray(cov1, np.float64), np.asarray(cov2, np.float64)
    diff = mu1 - mu2
    cov_sqrt = _sqrtm_psd(cov1 @ cov2)
    if not np.isfinite(cov_sqrt).all():
        offset = np.eye(cov1.shape[0]) * eps
        cov_sqrt = _sqrtm_psd((cov1 + offset) @ (cov2 + offset))
    if np.iscomplexobj(cov_sqrt):
        imag_max = float(np.max(np.abs(np.diagonal(cov_sqrt).imag)))
        if imag_max > 1e-3:
            raise ValueError(f"sqrtm has imaginary component {imag_max:g}")
        cov_sqrt = cov_sqrt.real
    return float(diff @ diff + np.trace(cov1) + np.trace(cov2) - 2 * np.trace(cov_sqrt))


def extract_features(feature_fn, image_batches: Iterable, n_samples: int,
                     device: str | torch.device = "cpu") -> np.ndarray:
    """The first ``n_samples`` features of [0, 1] NHWC batches (numpy or
    tensors), each moved to ``device``, as float32 numpy."""
    feats, total = [], 0
    for batch in image_batches:
        batch = torch.as_tensor(batch)
        feats.append(feature_fn(batch.to(device)).float().cpu().numpy())
        total += batch.shape[0]
        if total >= n_samples:
            break
    return np.concatenate(feats, axis=0)[:n_samples]


def extract_features_from_generator(gen_batch_fn, feature_fn, n_samples: int, batch_size: int,
                                    generator: torch.Generator | None = None) -> np.ndarray:
    """Features of ``ceil(n_samples / batch_size)`` generated batches, the
    first ``n_samples`` of them. ``gen_batch_fn(generator)`` returns [0, 1]
    images, or the features themselves when ``feature_fn`` is None (the
    chunk of :func:`make_gen_feature_fn`)."""
    feats = []
    for _ in range(-(-n_samples // batch_size)):
        out = gen_batch_fn(generator)
        out = out if feature_fn is None else feature_fn(out)
        feats.append(out.float().cpu().numpy())
    return np.concatenate(feats, axis=0)[:n_samples]


def load_stats(path: str | Path) -> tuple[np.ndarray, np.ndarray]:
    """The statistics pickle: {'mean': [D], 'cov': [D, D]}."""
    with open(path, "rb") as f:
        d = pickle.load(f)
    return np.asarray(d["mean"]), np.asarray(d["cov"])


def save_stats(path: str | Path, mean: np.ndarray, cov: np.ndarray) -> None:
    with open(path, "wb") as f:
        pickle.dump({"mean": mean, "cov": cov}, f)


def evaluate_fid(gen_batch_fn, feature_fn, real_stats_path: str | Path, n_samples: int = 50_000,
                 batch_size: int = 64, generator: torch.Generator | None = None,
                 return_features: bool = False):
    """FID of ``n_samples`` generated images against the statistics pickle
    (see :func:`extract_features_from_generator`). With
    ``return_features``, returns (fid, features)."""
    mu_real, cov_real = load_stats(real_stats_path)
    feats = extract_features_from_generator(gen_batch_fn, feature_fn, n_samples, batch_size,
                                            generator)
    fid = frechet_distance(*compute_stats(feats), mu_real, cov_real)
    return (fid, feats) if return_features else fid
