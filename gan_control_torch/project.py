"""GAN inversion command line of the port: project an image into w+.

    python -m gan_control_torch.project --model_dir <phase-1 dir> [--out projection_out] \
        [--target image.png] [--steps 600] [--lpips_vgg vgg16.pth --lpips_lin lin.pth] \
        [--mse_weight 0.1] [--seed 0] [--device cpu]

As the JAX package's ``examples/projection_example.py``: the target is the
image file (resized to the model's resolution) or, without one, a sample the
model generates; the projector starts at the mean w broadcast to w+ and
optimises (w+, the injection noises) on LPIPS + the noise penalty + MSE
(``projection.project``). LPIPS reads torchvision's ``vgg16`` and
richzhang's linear heads (or the JAX package's ``.msgpack``) when given;
without them its features are random, and the command says so. It writes
``target_vs_projection.jpg``, ``projected_w_plus.npy`` and ``history.json``
to ``--out``, and logs the loss at the first and last logged step, the
milliseconds per step and, on a GPU, the peak memory. The draws come from
``torch.Generator``s seeded from ``--seed``. It runs on the CUDA device
unless ``--device`` names another, and raises without a GPU.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model_dir", required=True)
    parser.add_argument("--out", default="projection_out")
    parser.add_argument("--target", default=None,
                        help="image file to invert (default: a sample generated by the model)")
    parser.add_argument("--steps", type=int, default=600)
    parser.add_argument("--lpips_vgg", default=None)
    parser.add_argument("--lpips_lin", default=None)
    parser.add_argument("--mse_weight", type=float, default=0.1)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: CUDA, which must be present)")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from gan_control_torch.evaluation.generation import save_image_grid
    from gan_control_torch.inference.inference import Inference
    from gan_control_torch.projection import lpips as lpips_lib
    from gan_control_torch.projection.projection import downsample_to_256, get_avg_latent, project
    from gan_control_torch.utils.logging_utils import get_logger
    from gan_control_torch.utils.weights import load_pretrained

    log = get_logger("gan_control_torch.project")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    model = Inference(args.model_dir, device=args.device)
    g = model.model
    device = model.device

    def generator(offset: int) -> torch.Generator:
        return torch.Generator(device=device).manual_seed(args.seed + offset)

    # 1. the target, [-1, 1] NHWC
    if args.target:
        from PIL import Image

        im = Image.open(args.target).convert("RGB").resize((g.size, g.size))
        target = torch.from_numpy(np.asarray(im, np.float32) / 127.5 - 1.0)[None].to(device)
    else:
        img01, _, _ = model.gen_batch(batch_size=1, generator=generator(7))
        target = img01 * 2.0 - 1.0
        log.info("no --target given: inverting a model-generated sample")
    target_s = downsample_to_256(target)  # the size the projector pools its images to

    # 2. LPIPS
    state = {}
    for path, kw in ((args.lpips_vgg, "vgg_path"), (args.lpips_lin, "lin_path")):
        sd = load_pretrained(path, lambda p, _kw=kw: lpips_lib.read_reference_state_dict(**{_kw: p}),
                             lpips_lib.state_dict_from_flax)
        if path and sd is None:
            raise FileNotFoundError(f"no LPIPS weights at {path}")
        state.update(sd or {})
    if not state:
        log.warning("no LPIPS weights: random perceptual features (a demonstration of the loop only; "
                    "the perceptual distance means nothing)")
    lpips = lpips_lib.make_lpips(state or None, seed=args.seed + 1, device=device)

    # 3. start at the mean w broadcast to w+, and optimise
    avg_w, w_std = get_avg_latent(g.map_latent, generator(2), style_dim=g.style_dim)
    latent_init = avg_w[None, None, :].expand(1, g.n_latent, g.style_dim).contiguous()

    def synth_fn(latent, noises):
        return g([latent], input_is_latent=True, noise=noises)[0]

    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    latent, noises, history = project(
        synth_fn, lpips, target_s, latent_init=latent_init, noise_shapes=g.noise_shapes(1),
        steps=args.steps, mse_weight=args.mse_weight, latent_std=w_std, generator=generator(0))
    if device.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0

    # 4. artifacts
    with torch.no_grad():
        recon = synth_fn(latent, noises).float()
    pair = torch.clamp(torch.cat([target, recon]) * 0.5 + 0.5, 0, 1)
    save_image_grid(pair, out / "target_vs_projection.jpg", nrow=2)
    np.save(out / "projected_w_plus.npy", latent.cpu().numpy())
    (out / "history.json").write_text(json.dumps(history, indent=1))
    first, last = history[0], history[-1]
    log.info("projection: loss %.6g (step %d) -> %.6g (step %d), %d steps in %.3f s = %.3f ms/step; "
             "artifacts in %s", first["loss"], first["step"], last["loss"], last["step"], args.steps,
             seconds, seconds / max(args.steps, 1) * 1e3, out)
    if device.type == "cuda":
        log.info("peak memory %.3f GiB", torch.cuda.max_memory_allocated() / 2**30)


if __name__ == "__main__":
    main()
