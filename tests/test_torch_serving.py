"""The port's serving path (``gan_control_torch/inference/serving.py``,
``exported.py``, ``row_noise.py``) against the JAX ``ServingController``,
on the CPU.

The fixture is ``tests/test_serving.py``'s tiny controller directory (a
16-px split-mapping generator, an orientation head and both expression
heads), written by the JAX package, with non-zero noise weights so that
the static noise counts; the port reads it through its flax bridge.

Tolerances: images as ``tests/test_torch_inference.py`` (f32 on both
sides, JAX at "highest"; 1e-5), w to 1e-5, uint8 within one level (the
two sides' floats may round to neighbouring levels). Within one bucket
the padding rows cannot change the first ``n`` rows at all (rows are
independent and the batch size is the same): exact. The exported program
runs the live path's ops: 1e-5.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gan_control_tpu.inference.serving import ServingController as JServing
from gan_control_tpu.models.controller import FcStack as JFcStack
from gan_control_tpu.models.factory import build_generator as j_build_generator
from gan_control_tpu.models.factory import build_group_spec as j_build_group_spec
from gan_control_tpu.utils import checkpoint as j_ckpt
from gan_control_tpu.utils.config import write_json

from gan_control_torch.inference.row_noise import row_noise
from gan_control_torch.inference.serving import ServingController as TServing
from gan_control_torch.models.blocks import EqualLinear, StyledConv

REPO = Path(__file__).resolve().parent.parent
STYLE = 64
SIZE = 16
IMG_TOL = dict(rtol=1e-5, atol=1e-5)
W_TOL = dict(rtol=1e-5, atol=1e-5)


def tiny_model_config():
    return {
        "save_name": "tiny",
        "model_config": {
            "vanilla": False, "img_channels": 3, "split_fc": True, "marge_fc": False,
            "latent_size": STYLE, "size": SIZE, "n_mlp": 2, "channel_multiplier": 0.25,
            "max_channels": 32, "g_noise_mode": "normal",
        },
        "training_config": {
            "batch": 8, "mini_batch": 8,
            "sub_groups_dict": {
                "orientation": {"place_in_mini_batch": [0, 4], "place_in_latent": [0, 24]},
                "expression": {"place_in_mini_batch": [4, 6], "place_in_latent": [24, 48]},
                "other": {"place_in_mini_batch": [6, 8], "place_in_latent": [48, 64]},
            },
        },
    }


@pytest.fixture(scope="module")
def controller_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_serving_ctrl")
    (root / "generator").mkdir()
    config = tiny_model_config()
    write_json(config, root / "generator" / "args.json")
    gen = j_build_generator(config, j_build_group_spec(config))
    params = jax.tree_util.tree_map(np.asarray, gen.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}, [jnp.zeros((1, STYLE))]))
    rng = np.random.default_rng(0)
    for mod in params["params"].values():
        if "noise" in mod:
            mod["noise"]["weight"] = rng.standard_normal(1).astype(np.float32)
    j_ckpt.save_checkpoint(root / "generator" / "checkpoint", {"g_ema": params}, 1)
    for seed, (name, in_dim) in enumerate((("orientation", 3), ("expression", 64),
                                           ("expression_q", 8)), start=2):
        cdir = root / f"{name}_serve"
        cdir.mkdir()
        write_json({"model_config": {"n_mlp": 2, "mid_dim": 32, "in_dim": in_dim, "lr_mlp": 0.01}},
                   cdir / "args.json")
        fc = JFcStack(n_mlp=2, mid_dim=32, out_dim=24, lr_mlp=0.01)
        j_ckpt.save_checkpoint(cdir / "checkpoint",
                               {"controller": fc.init(jax.random.PRNGKey(seed), jnp.zeros((1, in_dim)))}, 1)
    return root


@pytest.fixture(scope="module")
def both(controller_root):
    """The JAX and the port ServingController on one directory, with the
    same static noise."""
    js = JServing(controller_root, buckets=(4, 8))
    ts = TServing(controller_root, buckets=(4, 8), device="cpu")
    rng = np.random.default_rng(1)
    noise = [rng.standard_normal(s).astype(np.float32) for s in ts.model.noise_shapes(1)]
    js.noise = [jnp.asarray(n) for n in noise]
    ts.set_noise(noise)
    return js, ts


def _orientation(n, seed=0):
    return np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32) * 10.0


def _z(n, seed):
    return np.random.default_rng(seed).standard_normal((n, STYLE)).astype(np.float32)


CONTROL_SETS = {
    "orientation": lambda n: {"orientation": _orientation(n)},
    "orientation+expression64": lambda n: {
        "orientation": _orientation(n, 1),
        "expression": np.random.default_rng(2).standard_normal((n, 64)).astype(np.float32)},
    "expression_q": lambda n: {"expression": np.eye(8, dtype=np.float32)[:n]},
    "uncontrolled": lambda n: {},
}


@pytest.mark.parametrize("n", [3, 8])
@pytest.mark.parametrize("controls", sorted(CONTROL_SETS))
def test_generate_matches_jax(both, controls, n):
    """Same z and static noise: the port's images, z and assembled w are
    the JAX ServingController's (n = 3 pads to bucket 4)."""
    js, ts = both
    z = _z(n, 7)
    ctl = CONTROL_SETS[controls](n)
    ji, jz, jw = js.generate(latent=z, rng=jax.random.PRNGKey(3), **ctl)
    ti, tz, tw = ts.generate(latent=z, generator=torch.Generator().manual_seed(3), **ctl)
    assert ti.shape == (n, SIZE, SIZE, 3) and ti.dtype == np.float32
    np.testing.assert_allclose(ti, np.asarray(ji), **IMG_TOL)
    np.testing.assert_array_equal(tz, z)
    np.testing.assert_allclose(tw, np.asarray(jw), **W_TOL)


def test_uint8_within_one_level(both):
    js, ts = both
    z, ctl = _z(3, 8), {"orientation": _orientation(3, 4)}
    ju, _, _ = js.generate(latent=z, rng=jax.random.PRNGKey(0), output="uint8", **ctl)
    tu, _, _ = ts.generate(latent=z, output="uint8", **ctl)
    tf, _, _ = ts.generate(latent=z, **ctl)
    assert tu.dtype == np.uint8 and tu.shape == (3, SIZE, SIZE, 3)
    assert np.abs(tu.astype(np.int32) - np.asarray(ju).astype(np.int32)).max() <= 1
    np.testing.assert_array_equal(tu, np.round(tf * 255.0).astype(np.uint8))
    with pytest.raises(ValueError, match="output must be"):
        ts.generate(latent=z, output="float16", **ctl)


def test_expression_q_routing(both):
    """An 8-column expression goes to the expression_q head, a 64-column
    one to the 3DMM head; both write the 'expression' slice of w."""
    _, ts = both
    e8 = np.eye(8, dtype=np.float32)[:2]
    assert ts._route({"expression": e8})["expression"][0] == "expression_q"
    _, _, w8 = ts.generate(latent=_z(2, 9), expression=e8)
    want = ts.generate_group_w_latent("expression_q", e8).detach().numpy()
    np.testing.assert_allclose(w8[:, 24:48], want, rtol=1e-6, atol=1e-6)
    e64 = np.random.default_rng(3).standard_normal((2, 64)).astype(np.float32)
    assert ts._route({"expression": e64})["expression"][0] == "expression"
    _, _, w64 = ts.generate(latent=_z(2, 9), expression=e64)
    want = ts.generate_group_w_latent("expression", e64).detach().numpy()
    np.testing.assert_allclose(w64[:, 24:48], want, rtol=1e-6, atol=1e-6)


def test_bucket_ladder_and_errors(both):
    _, ts = both
    assert ts.buckets == (4, 8)
    assert [ts.bucket_for(n) for n in (1, 4, 5, 8)] == [4, 4, 8, 8]
    with pytest.raises(ValueError, match="exceeds the largest bucket"):
        ts.bucket_for(9)
    with pytest.raises(ValueError, match="control 'orientation' has 2 rows"):
        ts.generate(batch_size=3, orientation=_orientation(2))
    with pytest.raises(ValueError, match="no controller for group"):
        ts.generate(batch_size=2, hair=_orientation(2))
    with pytest.raises(ValueError, match="requires `latent`"):
        ts.generate(batch_size=2, input_is_latent=True)
    with pytest.raises(ValueError, match="need batch_size"):
        ts.generate()
    with pytest.raises(ValueError, match="invalid bucket ladder"):
        TServing(ts.model_dir.parent, buckets=(0, 4), device="cpu")
    assert ts.control_dim("orientation") == 3 and ts.control_dim("expression_q") == 8


def test_mesh_raises(controller_root):
    """A ladder that the mesh does not divide is refused at init, as the
    JAX ``ServingController`` refuses it (``test_meshed_serving_parity``)."""
    with pytest.raises(ValueError, match="not divisible"):
        TServing(controller_root, buckets=(3, 8), mesh=("cpu", "cpu"))
    with pytest.raises(ValueError, match="not divisible"):
        TServing(controller_root, buckets=(4, 8), mesh=("cpu",) * 8)


@pytest.mark.parametrize("static_noise", [True, False])
def test_meshed_serving_matches_one_device(controller_root, both, static_noise):
    """mesh=("cpu", "cpu"): the request's padded rows split over two
    replicas (bucket 8 -> 4 rows each; 5 rows -> 4 + 1) give the images of
    the one-device controller, with static noise and with per-row noise
    hashed at the global rows (JAX ``test_meshed_serving_parity``'s
    bound); ``set_noise`` reaches every replica."""
    _, ts = both
    meshed = TServing(controller_root, buckets=(4, 8), mesh=("cpu", "cpu"))
    meshed.set_noise([n.numpy() for n in ts.noise])
    assert meshed.device == torch.device("cpu")
    z, o = _z(5, 21), _orientation(5, 4)
    kw = dict(latent=z, orientation=o, static_noise=static_noise)
    img_m, z_m, w_m = meshed.generate(generator=torch.Generator().manual_seed(6), **kw)
    img_s, _, w_s = ts.generate(generator=torch.Generator().manual_seed(6), **kw)
    assert img_m.shape == (5, SIZE, SIZE, 3)
    np.testing.assert_array_equal(z_m, z)
    np.testing.assert_allclose(img_m, img_s, rtol=0, atol=2e-5)
    np.testing.assert_allclose(w_m, w_s, rtol=0, atol=2e-5)
    entry = meshed._serve_cache[((("orientation", "orientation"),), False, static_noise, "float32", 8,
                                 (STYLE,))]
    assert [r.bucket for r in entry.replicas] == [4, 4]
    assert [r.fn.row_offset for r in entry.replicas] == [0, 4]


def test_warmup_builds_every_set_and_bucket(controller_root):
    """Both expression heads: warmup builds the joint primary set and the
    expression_q set at each rung, and a warmed request builds nothing."""
    ts = TServing(controller_root, buckets=(2, 4), device="cpu")
    assert ts._default_group_sets() == [{"expression": 64, "orientation": 3}, {"expression": 8}]
    ts.warmup()
    primary = (("expression", "expression"), ("orientation", "orientation"))
    q = (("expression", "expression_q"),)
    want = {(h, False, True, "float32", b, (STYLE,)) for h in (primary, q) for b in (2, 4)}
    assert set(ts._serve_cache) == want
    img, _, _ = ts.generate(batch_size=3, orientation=_orientation(3),
                            expression=np.zeros((3, 64), np.float32))
    assert set(ts._serve_cache) == want
    assert img.shape == (3, SIZE, SIZE, 3) and np.isfinite(img).all()


@pytest.mark.parametrize("static_noise", [True, False])
def test_padding_leaves_the_first_rows_exact(both, static_noise):
    """Within one bucket, a request of 3 rows and one of 4 that shares
    them give the same first 3 rows, bit for bit, in both noise modes."""
    _, ts = both
    z4, o4 = _z(4, 11), _orientation(4, 5)
    kw = dict(static_noise=static_noise)
    i3, _, w3 = ts.generate(latent=z4[:3], orientation=o4[:3],
                            generator=torch.Generator().manual_seed(4), **kw)
    i4, _, w4 = ts.generate(latent=z4, orientation=o4, generator=torch.Generator().manual_seed(4), **kw)
    np.testing.assert_array_equal(i3, i4[:3])
    np.testing.assert_array_equal(w3, w4[:3])


def test_random_noise_bucket_invariance_and_seed(controller_root, both):
    """static_noise=False: the same request through ladders that pad it to
    bucket 4 and to bucket 8 gives the same first rows (per-row noise);
    another seed gives other images."""
    _, ts = both
    t8 = TServing(controller_root, buckets=(8,), device="cpu")
    z, o = _z(3, 12), _orientation(3, 6)
    a, _, wa = ts.generate(latent=z, orientation=o, static_noise=False,
                           generator=torch.Generator().manual_seed(7))
    b, _, wb = t8.generate(latent=z, orientation=o, static_noise=False,
                           generator=torch.Generator().manual_seed(7))
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(wa, wb, rtol=1e-5, atol=1e-6)
    c, _, _ = ts.generate(latent=z, orientation=o, static_noise=False,
                          generator=torch.Generator().manual_seed(8))
    assert np.isfinite(c).all() and not np.allclose(a, c)


def test_request_passes_one_latent(both):
    """The request function gives the generator one latent, so it never
    draws a style-mixing index (a host sync inside a capture)."""
    _, ts = both
    seen = []
    handle = ts.model.register_forward_pre_hook(lambda m, args: seen.append(len(args[0])))
    try:
        ts.generate(latent=_z(2, 13), orientation=_orientation(2))
        ts.generate(batch_size=2, static_noise=False)
    finally:
        handle.remove()
    assert seen == [1, 1]


SHAPES = [(8, 4, 4, 1), (8, 16, 16, 1), (8, 64, 64, 1)]


def test_row_noise_seeds_rows_and_buckets():
    seed = torch.tensor([123456789], dtype=torch.int64)
    a = row_noise(seed, SHAPES)
    b = row_noise(seed.clone(), SHAPES)
    short = row_noise(seed, [(3, *s[1:]) for s in SHAPES])
    other = row_noise(torch.tensor([123456790]), SHAPES)
    for x, y, s, o, shape in zip(a, b, short, other, SHAPES):
        assert x.shape == shape and x.dtype == torch.float32
        assert torch.equal(x, y)  # same seed, same draw
        assert torch.equal(x[:3], s)  # the first rows do not depend on the bucket
        assert not torch.allclose(x, o)  # another seed differs
        assert not torch.allclose(x[0], x[1])  # rows differ
    assert not torch.allclose(a[0][:, :4, :4], a[1][:, :4, :4])  # layers differ


def test_row_noise_is_standard_normal():
    """Mean and std over 2**17 values of each of two seeds within 0.01 of 0
    and 1 (their standard errors are 0.003 and 0.002)."""
    for seed in (0, 2**61 + 12345):
        (x,) = row_noise(torch.tensor([seed]), [(8, 128, 128, 1)])
        assert x.numel() == 2**17 and torch.isfinite(x).all()
        assert abs(float(x.mean())) < 0.01 and abs(float(x.std()) - 1.0) < 0.01


def _g_counts(ts, heads) -> tuple[int, int]:
    """fused_bias_act and blur2x_up calls of one request, from the modules."""
    fba = sum(isinstance(m, EqualLinear) and m.activation == "fused_lrelu"
              for m in [*ts.model.style.modules(), *(x for h in heads for x in ts.fc_controls[h].modules())])
    fba += sum(isinstance(m, StyledConv) for m in ts.model.modules())
    return fba, len(ts.model.to_rgbs)


_LOAD_SCRIPT = r"""
import json, sys
import numpy as np
import torch
from gan_control_torch.inference.exported import load_exported_serving
out = {}
for name, kw in json.loads(sys.argv[2]).items():
    ex = load_exported_serving(f"{sys.argv[1]}/{name}", device="cpu")
    ctl = {g: np.asarray(v, np.float32) for g, v in kw["controls"].items()}
    img, z, w = ex.generate(latent=np.asarray(kw["latent"], np.float32),
                            generator=torch.Generator().manual_seed(kw["seed"]), **ctl)
    out[name] = {"img": img.tolist(), "w": w.tolist(), "dtype": str(img.dtype)}
bad = sorted(m for m in sys.modules if m.startswith(("gan_control_torch.models",
             "gan_control_torch.utils.config", "gan_control_torch.utils.checkpoint", "jax", "flax",
             "gan_control_tpu")))
assert not bad, bad
print(json.dumps(out))
"""


def test_export_round_trip_in_a_fresh_interpreter(both, tmp_path):
    """Export at bucket 4 (static noise float32 and uint8, per-row noise,
    the uncontrolled set); a fresh interpreter that imports no model,
    config or checkpoint module of the port loads each and answers the
    same request as the live path, to 1e-5. Each program holds exactly the
    derived number of custom-op nodes of the two kernels."""
    _, ts = both
    cases = {
        "f32": dict(groups=["orientation"], static_noise=True, output="float32"),
        "u8": dict(groups=["orientation"], static_noise=True, output="uint8"),
        "rownoise": dict(groups=["orientation"], static_noise=False, output="float32"),
        "plain": dict(groups=[], static_noise=True, output="float32"),
    }
    requests = {}
    live = {}
    for name, kw in cases.items():
        manifest = ts.export_artifacts(tmp_path / name, buckets=(4,), **kw)
        assert manifest["static_noise"] == kw["static_noise"] and manifest["output"] == kw["output"]
        (entry,) = manifest["artifacts"]
        tag = "orientation3" if kw["groups"] else "uncontrolled"
        assert entry == {"file": f"serve_{tag}_b4.pt2", "bucket": 4, "dims": {g: 3 for g in kw["groups"]},
                         "device": "cpu", "dtype": "torch.float32"}
        program = torch.export.load(tmp_path / name / entry["file"])
        ops = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
        want_fba, want_up = _g_counts(ts, kw["groups"])
        assert ops.count("gan_control_torch.fused_bias_act.default") == want_fba
        assert ops.count("gan_control_torch.blur2x_up.default") == want_up
        ctl = {g: _orientation(3, 9) for g in kw["groups"]}
        z = _z(3, 14)
        requests[name] = {"latent": z.tolist(), "seed": 21, "controls": {g: v.tolist() for g, v in ctl.items()}}
        live[name] = ts.generate(latent=z, generator=torch.Generator().manual_seed(21),
                                 static_noise=kw["static_noise"], output=kw["output"], **ctl)
    assert _g_counts(ts, ["orientation"]) == (6 + 2 + 5, 2)  # mapping + head + StyledConvs; ToRGB skips
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _LOAD_SCRIPT, str(tmp_path), json.dumps(requests)],
                          capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    for name, (img, _, w) in live.items():
        assert got[name]["dtype"] == str(img.dtype)
        np.testing.assert_allclose(np.asarray(got[name]["img"]), img, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(np.asarray(got[name]["w"]), w, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="no exported artifact"):
        from gan_control_torch.inference.exported import load_exported_serving
        load_exported_serving(tmp_path / "f32", device="cpu").generate(
            batch_size=5, orientation=_orientation(5))


def test_new_static_noise_reaches_built_requests(controller_root):
    """The request graphs read the static noise planes where they were
    built: set_noise and reset_noise write into those planes, so a request
    after them uses the new noise, as gen_batch_by_controls does."""
    ts = TServing(controller_root, buckets=(4,), device="cpu")
    z, o = _z(4, 15), _orientation(4, 7)  # a full bucket: the eager call runs the same batch
    planes = ts.noise
    before, _, _ = ts.generate(latent=z, orientation=o)
    ts.set_noise([np.full(s, 0.5, np.float32) for s in ts.model.noise_shapes(1)])
    after, _, _ = ts.generate(latent=z, orientation=o)
    want, _, _ = ts.gen_batch_by_controls(latent=z, orientation=o)
    assert ts.noise is planes and not np.allclose(before, after)
    np.testing.assert_array_equal(after, want.numpy())
    ts.reset_noise(torch.Generator().manual_seed(3))
    again, _, _ = ts.generate(latent=z, orientation=o)
    want, _, _ = ts.gen_batch_by_controls(latent=z, orientation=o)
    assert ts.noise is planes
    np.testing.assert_array_equal(again, want.numpy())
