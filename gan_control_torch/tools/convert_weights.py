"""Convert every pretrained checkpoint found under ``--root`` to the JAX
package's flax msgpack, record golden probe values, and report what is
missing (counterpart of the JAX package's ``tools/convert_weights.py``;
the sources are listed in WEIGHTS.md).

    python -m gan_control_torch.tools.convert_weights --root pretrained_models [--out DIR]
        [--only NAME ...] [--device cpu]
    python -m gan_control_torch.tools.convert_weights --root pretrained_models --validate
    python -m gan_control_torch.tools.convert_weights --root pretrained_models --verify-sha

Each checkpoint is read by its net's own ``read_reference_state_dict`` and
loaded (strictly) into the port's net; ``<out>/<name>.msgpack`` holds the
net's parameters in the JAX package's flax layout (each module's
``state_dict_to_flax``, written by ``utils/checkpoint.py``), so one
conversion serves both packages: the JAX package restores it with flax,
the port through ``utils/weights.load_pretrained``. The net is then probed
with a deterministic input (numpy seed 1234, the JAX tool's sizes and
ranges, at f32 with TF32 off), and ``<out>/goldens.json`` records a summary
of the probe's output in the JAX package's layout (shape, first 8 values,
mean, std) beside the source's sha256. ``--validate`` rebuilds each net
from its stored msgpack, probes it again and compares with the goldens
(relative 1e-3, absolute 1e-4), catching corrupted, truncated or swapped
files; it reads goldens written by either package. ``--verify-sha`` checks
the sources against the published sha256 prefixes and against the digests
recorded by an earlier run (``<out>/sha256s.json``).

It runs on CUDA unless ``--device`` names another device.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import hashlib
import importlib
import json
import os

import numpy as np
import torch


def _probe_image(size: int, channels: int = 3, lo: float = -1.0, hi: float = 1.0) -> np.ndarray:
    rng = np.random.default_rng(1234)
    x = rng.random((1, size, size, channels), dtype=np.float32)
    return x * (hi - lo) + lo


@contextlib.contextmanager
def _f32_highest():
    """TF32 off for cuDNN convs and cuBLAS matmuls, restored on exit."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _frozen(net: torch.nn.Module, device) -> torch.nn.Module:
    return net.float().eval().requires_grad_(False).to(device)


def _image(size: int, device, nchw: bool = False, **kw) -> torch.Tensor:
    x = torch.from_numpy(_probe_image(size, **kw)).to(device)
    return x.permute(0, 3, 1, 2) if nchw else x


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).cpu().numpy()


def _predictor_entry(loss_name: str, mod_name: str, patterns, probe_size: int = 128) -> dict:
    """A ``losses/predictors`` net: its last feature layer on the probe."""
    mod = f"gan_control_torch.losses.predictors.{mod_name}"

    def build(sd, device):
        net = importlib.import_module(mod).make_model({"center_crop": None})
        net.load_state_dict(sd, strict=True)
        return _frozen(net, device)

    def probe(net, device):
        return net(_image(probe_size, device))[-1].cpu().numpy()

    return {"name": loss_name, "patterns": patterns, "module": mod, "build": build, "probe": probe}


def _fan_entry() -> dict:
    def build(sd, device):
        from gan_control_torch.alignment import fan

        return _frozen(fan.make_fan(state_dict=sd).net, device)

    def probe(net, device):
        return _nhwc(net(_image(256, device, nchw=True, lo=0.0))[-1])

    # 3DFAN4 first: a face_alignment cache usually holds 2DFAN4 too, and a
    # bare *DFAN4* glob would sort 2DFAN4 ahead of the 3D checkpoint that
    # the alignment pipeline (and the sha pin) expects
    return {"name": "fan", "patterns": ["*3DFAN4*.pth*", "*3DFAN-4*.pth*", "*DFAN4*.pth*", "*DFAN-4*.pth*"],
            "module": "gan_control_torch.alignment.fan", "build": build, "probe": probe}


def _sfd_entry() -> dict:
    def build(sd, device):
        from gan_control_torch.alignment import sfd

        net = sfd.S3FD()
        net.load_state_dict(sd, strict=True)
        return _frozen(net, device)

    def probe(net, device):
        return _nhwc(net(_image(128, device, nchw=True, lo=-120.0, hi=130.0))[0][0])

    return {"name": "sfd", "patterns": ["s3fd*.pth"], "module": "gan_control_torch.alignment.sfd",
            "build": build, "probe": probe}


def _blazeface_entry() -> dict:
    def build(sd, device):
        from gan_control_torch.alignment import blazeface

        net = blazeface.BlazeFaceNet()
        net.load_state_dict(sd, strict=True)
        return _frozen(net, device)

    def probe(net, device):
        return net(_image(128, device, nchw=True))[0].cpu().numpy()

    return {"name": "blazeface", "patterns": ["blazeface*.pth"],
            "module": "gan_control_torch.alignment.blazeface", "build": build, "probe": probe}


def _inception_entry() -> dict:
    from gan_control_torch.utils import flax_bridge

    def build(sd, device):
        from gan_control_torch.evaluation import inception

        net = inception.InceptionV3Features()
        net.load_state_dict(sd, strict=True)
        return _frozen(net, device)

    def probe(net, device):
        return net(_image(299, device, lo=0.0)).cpu().numpy()

    return {"name": "fid_inception", "patterns": ["pt_inception*.pth"],
            "module": "gan_control_torch.evaluation.inception", "build": build, "probe": probe,
            "to_flax": flax_bridge.inception_state_dict_to_flax,
            "from_flax": flax_bridge.inception_state_dict_from_flax}


def _lpips_entry() -> dict:
    def read(path):
        # path = the lin weights; the vgg16 backbone must live next to them
        # or one directory up (e.g. root/lpips/vgg.pth + root/vgg16-*.pth)
        from gan_control_torch.projection import lpips

        base = os.path.dirname(path)
        vgg = _find(base, ["vgg16*.pth"]) or _find(os.path.dirname(base) or ".", ["vgg16*.pth"])
        if vgg is None:
            raise FileNotFoundError(
                f"lpips lin weights found at {path} but no vgg16*.pth backbone near it: "
                f"converting without it would give a randomly-initialized LPIPS (see WEIGHTS.md)")
        return lpips.read_reference_state_dict(vgg, path)

    def build(sd, device):
        from gan_control_torch.projection import lpips

        return _frozen(lpips.make_lpips(sd), device)

    def probe(net, device):
        return net(_image(64, device), -_image(64, device)).cpu().numpy()

    return {"name": "lpips", "patterns": ["lpips_vgg*.pth", "lpips/vgg.pth"],
            "module": "gan_control_torch.projection.lpips", "read": read, "build": build, "probe": probe}


def make_specs() -> list[dict]:
    """The JAX tool's fourteen entries, in its order. Each: ``name``,
    ``patterns``, ``read`` (source path -> state_dict), ``to_flax`` and
    ``from_flax`` (state_dict <-> flax tree), ``build`` (state_dict, device
    -> net) and ``probe`` (net, device -> numpy output in the JAX layout)."""
    specs = [
        _predictor_entry("embedding_loss", "arcface", ["model_ir_se50.pth"], 112),
        _predictor_entry("orientation_loss", "hopenet", ["hopenet_robust_alpha1.pkl"]),
        _predictor_entry("expression_loss", "esr9", ["esr_9"]),
        _predictor_entry("age_loss", "dex_age", ["dex_imdb_wiki.pt"]),
        _predictor_entry("hair_loss", "hair_pspnet", ["pspnet_resnet101*.pth"]),
        _predictor_entry("recon_3d_loss", "face3dmm",
                         ["face3dmm_recon/models/pytorch_converted_model.pt",
                          "face3dmm_recon/pytorch_converted_model.pt"]),
        _predictor_entry("dog_id_loss", "dogfacenet",
                         ["dogfacenet/models/pytorch_converted_model.pt",
                          "dogfacenet/pytorch_converted_model.pt"]),
        _predictor_entry("style_loss", "vgg_style", ["vgg16*.pth"]),
        _predictor_entry("classification_loss", "imagenet_cls", ["resnet18*.pth"]),
        _inception_entry(),
        _fan_entry(),
        _sfd_entry(),
        _blazeface_entry(),
        _lpips_entry(),
    ]
    for spec in specs:
        mod = importlib.import_module(spec["module"])
        spec.setdefault("read", mod.read_reference_state_dict)
        spec.setdefault("to_flax", getattr(mod, "state_dict_to_flax", None))
        spec.setdefault("from_flax", getattr(mod, "state_dict_from_flax", None))
    return specs


# sha256 pins of the source checkpoints. torch-hub-convention files embed
# the leading hex of their sha256 in the FILE NAME: that prefix is the pin
# (torch.hub.load_state_dict_from_url enforces exactly this). The other
# checkpoints are distributed without published digests: their pins are
# RECORDED by --verify-sha on the first machine that has them, so every
# later conversion is checked against the first verified copy (WEIGHTS.md).
KNOWN_SHA256_PREFIXES = {
    "fid_inception": "6726825d",        # pt_inception-2015-12-05-6726825d.pth
    "style_loss": "397923af",           # vgg16-397923af.pth
    "classification_loss": "f37072fd",  # resnet18-f37072fd.pth
    "sfd": "619a316812",                # s3fd-619a316812.pth
    "fan": "7835d9f11d",                # 3DFAN4-7835d9f11d.pth.tar
}


def verify_sha(specs, root: str, out_dir: str) -> int:
    """Hash every present source checkpoint, check it against the file-name
    pins and any digest recorded before, and write the full digests to
    ``<out>/sha256s.json`` (the recorded manifest)."""
    manifest_path = os.path.join(out_dir, "sha256s.json")
    manifest = json.load(open(manifest_path)) if os.path.exists(manifest_path) else {}
    failed, checked, recorded = [], 0, []
    for spec in specs:
        name = spec["name"]
        src = _find(root, spec["patterns"])
        if src is None:
            continue
        digest = _sha256(src)
        checked += 1
        pin = KNOWN_SHA256_PREFIXES.get(name)
        if pin is not None and not digest.startswith(pin):
            failed.append(name)
            print(f"  MISMATCH {name}: sha256 {digest[:16]}… does not start with the published pin "
                  f"{pin} ({src})")
            continue
        prev = manifest.get(name)
        if prev is not None and prev["sha256"] != digest:
            failed.append(name)
            print(f"  MISMATCH {name}: sha256 {digest[:16]}… != previously recorded "
                  f"{prev['sha256'][:16]}… ({src})")
            continue
        if prev is None:
            recorded.append(name)
        manifest[name] = {"source": os.path.basename(src), "sha256": digest}
        print(f"  OK      {name}  {digest[:16]}…" + ("  [pinned]" if pin else "  [recorded]"))
    os.makedirs(out_dir, exist_ok=True)
    with open(manifest_path, "w") as f:
        json.dump(manifest, f, indent=2)
    print(f"verified {checked} checkpoints, {len(failed)} mismatches"
          + (f", recorded {len(recorded)} new digests" if recorded else ""))
    return 1 if failed else 0


def _find(root: str, patterns) -> str | None:
    for pat in patterns:
        hits = sorted(glob.glob(os.path.join(root, pat)))
        hits += sorted(glob.glob(os.path.join(root, "**", pat), recursive=True))
        if hits:
            return hits[0]
    return None


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    files = (sorted(f for f in glob.glob(os.path.join(path, "**", "*"), recursive=True) if os.path.isfile(f))
             if os.path.isdir(path) else [path])
    for fp in files:
        with open(fp, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 22), b""):
                h.update(chunk)
    return h.hexdigest()


def _golden_summary(out: np.ndarray) -> dict:
    flat = np.asarray(out).reshape(-1).astype(np.float64)
    return {"shape": list(out.shape), "first8": [float(v) for v in flat[:8]],
            "mean": float(flat.mean()), "std": float(flat.std())}


def _goldens_match(a: dict, b: dict, rtol=1e-3, atol=1e-4) -> bool:
    return (a["shape"] == b["shape"]
            and np.allclose(a["first8"], b["first8"], rtol=rtol, atol=atol)
            and np.isclose(a["mean"], b["mean"], rtol=rtol, atol=atol)
            and np.isclose(a["std"], b["std"], rtol=rtol, atol=atol))


def probe_summary(spec: dict, sd: dict, device) -> dict:
    """The golden summary of ``spec``'s net built from ``sd`` on ``device``."""
    with torch.no_grad(), _f32_highest():
        net = spec["build"](sd, device)
        return _golden_summary(spec["probe"](net, device))


def validate(specs, out_dir: str, device) -> dict[str, tuple[bool, dict, dict]]:
    """Each net with a stored msgpack and a golden, rebuilt from the msgpack
    and probed on ``device``: ``{name: (match, probe summary, golden)}``."""
    from gan_control_torch.utils import checkpoint as ckpt_lib

    goldens = json.load(open(os.path.join(out_dir, "goldens.json")))
    results = {}
    for spec in specs:
        name = spec["name"]
        mp = os.path.join(out_dir, f"{name}.msgpack")
        if name not in goldens or not os.path.exists(mp):
            continue
        got = probe_summary(spec, spec["from_flax"](ckpt_lib.load_state_dict(mp)), device)
        results[name] = (_goldens_match(got, goldens[name]["golden"]), got, goldens[name]["golden"])
    return results


def convert(specs, root: str, out_dir: str, device) -> tuple[list[str], list[tuple[str, str]]]:
    """Converts every spec whose source is under ``root`` into ``out_dir``
    (msgpack and golden). Returns (converted names, missing (name, what))."""
    from gan_control_torch.utils import checkpoint as ckpt_lib

    os.makedirs(out_dir, exist_ok=True)
    goldens_path = os.path.join(out_dir, "goldens.json")
    goldens = json.load(open(goldens_path)) if os.path.exists(goldens_path) else {}
    converted, missing = [], []
    for spec in specs:
        name = spec["name"]
        src = _find(root, spec["patterns"])
        if src is None:
            missing.append((name, spec["patterns"][0]))
            continue
        digest = _sha256(src)
        pin = KNOWN_SHA256_PREFIXES.get(name)
        if pin is not None and not digest.startswith(pin):
            # warn and convert: --verify-sha is the strict gate (test
            # fixtures and retrained checkpoints legitimately differ)
            print(f"  WARNING {name}: sha256 {digest[:16]}… does not start with the published pin "
                  f"{pin} ({src}): not the canonical checkpoint; run --verify-sha to enforce")
        print(f"converting {name} from {src} ...")
        try:
            sd = spec["read"](src)
        except FileNotFoundError as e:
            print(f"  SKIP {name}: {e}")
            missing.append((name, str(e)))
            continue
        blob = ckpt_lib.msgpack_serialize(spec["to_flax"](sd))
        mp = os.path.join(out_dir, f"{name}.msgpack")
        with open(mp, "wb") as f:
            f.write(blob)
        golden = probe_summary(spec, sd, device)
        goldens[name] = {"source": src, "source_sha256": digest, "golden": golden}
        converted.append(name)
        print(f"  -> {mp} ({len(blob) / 1e6:.1f} MB), probe mean={golden['mean']:.6g} "
              f"std={golden['std']:.6g}")
    with open(goldens_path, "w") as f:
        json.dump(goldens, f, indent=2)
    return converted, missing


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default="pretrained_models")
    ap.add_argument("--out", default=None, help="default: <root>/converted")
    ap.add_argument("--validate", action="store_true",
                    help="re-probe converted msgpacks against goldens.json")
    ap.add_argument("--verify-sha", action="store_true",
                    help="hash present source checkpoints against the pins and the recorded "
                    "sha256s.json manifest")
    ap.add_argument("--only", nargs="*", default=None, help="limit to these entry names")
    ap.add_argument("--device", default=None, help="torch device (default: CUDA, which must be present)")
    args = ap.parse_args(argv)
    out_dir = args.out or os.path.join(args.root, "converted")

    specs = make_specs()
    if args.only:
        specs = [s for s in specs if s["name"] in args.only]
    if args.verify_sha:
        return verify_sha(specs, args.root, out_dir)

    from gan_control_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    if args.validate:
        results = validate(specs, out_dir, device)
        for name, (ok, got, want) in results.items():
            print(f"  OK      {name}" if ok else f"  MISMATCH {name}: {got} != {want}")
        failed = [n for n, (ok, _, _) in results.items() if not ok]
        print(f"validated {len(results)} converted nets, {len(failed)} mismatches")
        return 1 if failed else 0

    converted, missing = convert(specs, args.root, out_dir, device)
    print(f"\nconverted ({len(converted)}): {', '.join(converted) or '-'}")
    if missing:
        print(f"MISSING ({len(missing)}) — see WEIGHTS.md for sources:")
        for name, pat in missing:
            print(f"  {name}: expected {os.path.join(args.root, pat)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
