"""``gan_control_torch/tools/convert_weights.py`` against the JAX package's
``tools/convert_weights.py`` on the CPU.

  - every net's ``state_dict_to_flax`` inverts its ``state_dict_from_flax``:
    a random-init state_dict comes back bitwise, every tensor and no other;
  - ESR-9 and Hopenet, written at random init in their reference
    checkpoints' layouts (ESR-9's ten files, Hopenet's ``fc_finetune``),
    converted by both tools: the msgpack files hold the same leaves,
    bitwise; the goldens agree under the tool's ``_goldens_match``; the
    port's ``--validate`` passes on what the JAX tool wrote and fails once
    a golden is corrupted;
  - ``--verify-sha``: a file-name pin is enforced, an unpinned file's digest
    is recorded in ``sha256s.json`` and enforced on the next run, as
    ``tests/test_convert_weights_tool.py`` checks the JAX tool;
  - the JAX registry loads the port-written msgpack (the same leaves as the
    JAX converter's own);
  - a whole torchvision VGG16 (13 convs) loads into the port's style-loss
    net, as the JAX converter reads it (it keeps the 10 convs it uses).
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from gan_control_torch.alignment import blazeface, depth, fan, sfd
from gan_control_torch.evaluation import inception
from gan_control_torch.losses.predictors import PREDICTOR_MODULES, predictor_module
from gan_control_torch.losses.predictors.common import init_predictor_
from gan_control_torch.projection import lpips
from gan_control_torch.tools import convert_weights as tcw
from gan_control_torch.utils import checkpoint as ckpt_lib
from gan_control_torch.utils import flax_bridge

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))

import convert_weights as jcw  # noqa: E402

from test_torch_predictors import TC, _save_reference_layout  # noqa: E402

CONVERTED = ("expression_loss", "orientation_loss")
REFERENCE_NAMES = {"orientation_loss": "hopenet_robust_alpha1.pkl"}


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch thread: the suite runs six workers on the box's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _predictor(loss, seed):
    return init_predictor_(predictor_module(loss).make_model({"center_crop": None}), seed)


NETS = {
    **{loss: (lambda loss=loss: _predictor(loss, 1), predictor_module(loss)) for loss in PREDICTOR_MODULES},
    "fan": (lambda: fan.make_fan(seed=1).net, fan),
    "depth": (lambda: depth.make_depth(seed=1).net, depth),
    "sfd": (lambda: init_predictor_(sfd.S3FD(), 1), sfd),
    "blazeface": (lambda: init_predictor_(blazeface.BlazeFaceNet(), 1), blazeface),
    "lpips": (lambda: lpips.make_lpips(seed=1), lpips),
    "fid_inception": (lambda: inception.init_params(1), None),
}


@pytest.mark.parametrize("name", sorted(NETS))
def test_to_flax_inverts_from_flax(name):
    make, mod = NETS[name]
    to_flax, from_flax = ((mod.state_dict_to_flax, mod.state_dict_from_flax) if mod is not None else
                          (flax_bridge.inception_state_dict_to_flax, flax_bridge.inception_state_dict_from_flax))
    sd = {k: v for k, v in make().state_dict().items() if not k.endswith("num_batches_tracked")}
    tree = to_flax(sd)
    assert set(tree) == {"params"}
    back = from_flax(tree)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """ESR-9 and Hopenet in the reference layout under ``root``, converted by
    both tools (the port's on the CPU)."""
    root = tmp_path_factory.mktemp("pretrained")
    for i, loss in enumerate(CONVERTED):
        model = predictor_module(loss).make_model(TC[loss])
        path = _save_reference_layout(loss, init_predictor_(model, 30 + i).state_dict(), root)
        if loss in REFERENCE_NAMES:
            Path(path).rename(root / REFERENCE_NAMES[loss])
    assert jcw.main(["--root", str(root), "--out", str(root / "jax"), "--only", *CONVERTED]) == 0
    assert tcw.main(["--root", str(root), "--out", str(root / "port"), "--only", *CONVERTED,
                     "--device", "cpu"]) == 0
    return root


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("name", CONVERTED)
def test_msgpack_leaves_equal_the_jax_tools(converted, name):
    import flax.serialization

    want = _leaves(flax.serialization.msgpack_restore((converted / "jax" / f"{name}.msgpack").read_bytes()))
    got = _leaves(ckpt_lib.load_state_dict(converted / "port" / f"{name}.msgpack"))
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape and np.array_equal(got[k], w), k


def test_goldens_match_the_jax_tools(converted):
    want = json.loads((converted / "jax" / "goldens.json").read_text())
    got = json.loads((converted / "port" / "goldens.json").read_text())
    assert got.keys() == want.keys() == set(CONVERTED)
    for name in CONVERTED:
        assert got[name]["source_sha256"] == want[name]["source_sha256"]
        assert jcw._goldens_match(got[name]["golden"], want[name]["golden"]), name
        assert tcw._goldens_match(got[name]["golden"], want[name]["golden"]), name


def test_validate_reads_what_the_jax_tool_wrote(converted, capsys, tmp_path):
    import shutil

    out = tmp_path / "jax"
    shutil.copytree(converted / "jax", out)
    assert tcw.main(["--root", str(converted), "--out", str(out), "--validate", "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert all(f"OK      {n}" in text for n in CONVERTED)
    goldens = json.loads((out / "goldens.json").read_text())
    goldens["orientation_loss"]["golden"]["mean"] += 1.0
    (out / "goldens.json").write_text(json.dumps(goldens))
    assert tcw.main(["--root", str(converted), "--out", str(out), "--validate", "--device", "cpu"]) == 1
    assert "MISMATCH orientation_loss" in capsys.readouterr().out


def test_verify_sha_pins_and_manifest(tmp_path, capsys):
    root = tmp_path / "pretrained"
    root.mkdir()
    (root / "vgg16-397923af.pth").write_bytes(b"not the published vgg16")
    (root / "hopenet_robust_alpha1.pkl").write_bytes(b"fake-hopenet-weights")
    assert tcw.main(["--root", str(root), "--verify-sha"]) == 1  # the vgg16 pin fails
    out = capsys.readouterr().out
    assert "MISMATCH style_loss" in out
    assert "OK      orientation_loss" in out and "[recorded]" in out
    manifest = json.loads((root / "converted" / "sha256s.json").read_text())
    assert len(manifest["orientation_loss"]["sha256"]) == 64 and "style_loss" not in manifest
    # the JAX tool accepts the port's manifest and flags the same tampering
    (root / "hopenet_robust_alpha1.pkl").write_bytes(b"tampered")
    for main in (tcw.main, jcw.main):
        assert main(["--root", str(root), "--verify-sha", "--only", "orientation_loss"]) == 1
        assert "MISMATCH orientation_loss" in capsys.readouterr().out


def test_jax_registry_loads_the_ports_msgpack(converted):
    from gan_control_tpu.losses.predictors import hopenet as jhop
    from gan_control_tpu.losses.registry import build_attr_losses

    tc = {"orientation_loss": dict(TC["orientation_loss"], enabled=True,
                                   model_path=str(converted / "port" / "orientation_loss.msgpack"))}
    specs, params = build_attr_losses(tc)
    assert [s.name for s in specs] == ["orientation_loss"]
    direct = jhop.convert_torch_weights(jhop.make_model(tc["orientation_loss"]),
                                        str(converted / "hopenet_robust_alpha1.pkl"))
    got, want = _leaves(params["orientation_loss"]), _leaves(direct)
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k], want[k]) for k in want)


def test_whole_torchvision_vgg16_loads_for_the_style_loss(tmp_path):
    """A torchvision vgg16 state_dict holds 13 convs (and the classifier);
    the style net uses 10 of them. The port reads them as the JAX converter
    does, so the registry's strict load takes the real file."""
    from gan_control_tpu.losses.predictors import vgg_style as jvgg

    from gan_control_torch.losses.registry import build_predictor

    backbone = lpips.make_lpips(seed=3).state_dict()  # torchvision vgg16.features' 13 convs
    sd = {f"features.{k[len('vgg.conv'):]}": v for k, v in backbone.items() if k.startswith("vgg.")}
    sd["classifier.0.weight"] = torch.zeros(4, 8)
    path = tmp_path / "vgg16-397923af.pth"
    torch.save(sd, path)
    model = build_predictor("style_loss", {"model_path": str(path), "center_crop": None}, "cpu", 0)
    want = jvgg.convert_torch_weights(jvgg.make_model({"center_crop": None}), str(path))
    got = predictor_module("style_loss").state_dict_from_flax(jax.tree_util.tree_map(np.asarray, want))
    assert model.state_dict().keys() == got.keys()
    assert all(torch.equal(model.state_dict()[k], got[k]) for k in got)
