"""Controlled-inference walkthrough (the port's counterpart of the JAX
package's ``examples/inference_example.py`` and of the cells of
``examples/gan_control_inference_example.ipynb``).

Given a trained controller directory, it writes:
  1. ``samples.jpg``: unconditional samples, truncated 0.7 toward the mean w;
  2. ``controlled.jpg``: the same latents with explicit controls (pose,
     age, hair colour, and illumination from a light direction through
     ``gamma_from_direction``), for each head the directory has;
  3. ``interp_<group>.gif``: an interpolation of the first controllable
     group;
  4. ``recovered_controls.jpg``: the controls read back from the samples by
     ``ControlExtractor`` and applied to new identities (when the
     generator's ``args.json`` enables predictor loss blocks; random
     predictors without their weights).

    python -m gan_control_torch.examples.inference_example
        --controller_dir DIR [--out inference_out] [--batch 4] [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--controller_dir", required=True)
    parser.add_argument("--out", default="inference_out")
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--device", default=None, help="CUDA unless given (e.g. cpu)")
    args = parser.parse_args(argv)

    from gan_control_torch.evaluation.generation import save_image_grid
    from gan_control_torch.inference.controller import Controller
    from gan_control_torch.inference.interpolation import interpolate_by_group, save_gif
    from gan_control_torch.utils.spherical_harmonics import gamma_from_direction

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    ctrl = Controller(args.controller_dir, device=args.device)
    n = args.batch

    def rng(seed: int) -> torch.Generator:
        return torch.Generator(device=ctrl.device).manual_seed(seed)

    # 1. unconditional samples (truncation 0.7 toward the per-group mean w)
    imgs, z, _ = ctrl.gen_batch(batch_size=n, truncation=0.7, generator=rng(0))
    save_image_grid(imgs, out / "samples.jpg", nrow=n)

    # 2. explicit controls on the same latents: same people, new attributes
    controls = {}
    if "orientation" in ctrl.fc_controls:
        controls["orientation"] = np.tile([[25.0, 5.0, 0.0]], (n, 1))
    if "age" in ctrl.fc_controls:
        controls["age"] = np.full((n, 1), 60.0)
    if "hair" in ctrl.fc_controls:
        controls["hair"] = np.tile([[0.9, 0.2, 0.2]], (n, 1))  # red
    if "gamma" in ctrl.fc_controls:
        controls["gamma"] = np.tile(gamma_from_direction(1.0, 0.0, 0.5)[None], (n, 1))
    if controls:
        imgs2, _, _ = ctrl.gen_batch_by_controls(batch_size=n, latent=z, generator=rng(0), **controls)
        save_image_grid(imgs2, out / "controlled.jpg", nrow=n)

    # 3. an interpolation gif of the first controllable group
    for group in list(ctrl.fc_controls)[:1]:
        if group == "expression_q":
            continue
        g = ctrl.spec.group(group)
        frames, _ = interpolate_by_group(
            ctrl.model, (g.latent_start, g.latent_end), rng(1), batch=n,
            num_of_intermediate_latents=2, pics_per_interpolation=6, style_dim=ctrl.style_dim)
        save_gif(frames, out / f"interp_{group}.gif", nrow=n)

    # 4. controls read back from the samples and applied to new identities;
    #    the predictors run when the phase-1 config enables their losses
    tc = ctrl.config.get("training_config", {})
    extractable = {k: tc[k] for k in ("orientation_loss", "age_loss", "hair_loss")
                   if isinstance(tc.get(k), dict) and tc[k].get("enabled")}
    if extractable:
        from gan_control_torch.inference.extract_controls import ControlExtractor

        extractor = ControlExtractor(extractable, device=ctrl.device)
        recovered = extractor.extract(imgs * 2.0 - 1.0)
        reapply = {}
        for group in ("orientation", "age", "hair"):
            if group in recovered and group in ctrl.fc_controls:
                v = np.asarray(recovered[group], np.float32)
                reapply[group] = v.reshape(len(v), -1)
        if reapply:
            imgs3, _, _ = ctrl.gen_batch_by_controls(batch_size=n, generator=rng(7), **reapply)
            save_image_grid(imgs3, out / "recovered_controls.jpg", nrow=n)
    else:
        print("step 4 (extract controls) skipped: the generator's args.json enables no "
              "predictor loss block")

    print(f"wrote {sorted(p.name for p in out.iterdir())} -> {out}")


if __name__ == "__main__":
    main()
