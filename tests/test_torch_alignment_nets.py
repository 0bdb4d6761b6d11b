"""Parity of the port's alignment nets with the JAX package's, at the small
forms the JAX tests use: ``FAN(num_modules=1)``, ``ResNetDepth`` with stages
(1, 1, 1, 1), S3FD at 64 px and BlazeFace at 128 px, random init from
seeds, the JAX parameters carried over by the bridge
(``net_state_dict_from_flax``).

  - each net's outputs at f32 (JAX at "highest") to 1e-4 of their largest
    entry;
  - ``detect`` of both detectors on the same parameters: the same boxes to
    1e-4 of their largest coordinate;
  - FAN's landmarks (with the depth net's z): x and y equal (floors of the
    same peaks), z to 1e-4;
  - ``make_align_fn`` end to end (SFD, FAN, depth, the warp): the same
    aligned crops. The S3FD's box regressors are zeroed there, so that its
    boxes are its anchors: a random regressor's best box lies off the
    frame, where the JAX crop raises (the port takes the whole image);
  - a state_dict saved with ``torch.save`` in the reference checkpoint's
    names (1adrianb FAN and S3FD, the depth net's ``module.`` prefix under
    ``state_dict``, hollance BlazeFace) read by the JAX
    ``convert_torch_weights`` and by the port's reader gives equal outputs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gan_control_tpu import alignment as jalign
from gan_control_tpu.alignment import blazeface as jbf
from gan_control_tpu.alignment import depth as jdepth
from gan_control_tpu.alignment import fan as jfan
from gan_control_tpu.alignment import sfd as jsfd

from gan_control_torch import alignment as talign
from gan_control_torch.alignment import blazeface as tbf
from gan_control_torch.alignment import depth as tdepth
from gan_control_torch.alignment import fan as tfan
from gan_control_torch.alignment import sfd as tsfd
from gan_control_torch.losses.predictors.common import init_predictor_
from gan_control_torch.utils.flax_bridge import net_state_dict_from_flax

REL = 1e-4
LAYERS = (1, 1, 1, 1)


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch thread: the suite runs six workers on the box's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(float(np.abs(want).max()), 1e-12))


def _images(n, size, seed):
    rng = np.random.default_rng(seed)
    small = rng.uniform(-1, 1, (n, 8, 8, 3)).astype(np.float32)
    return np.array(jax.image.resize(jnp.asarray(small), (n, size, size, 3), "linear"))


@pytest.fixture(scope="module")
def nets():
    """The JAX nets and parameters, with one jitted forward each (shared,
    so each shape compiles once)."""
    fan = jfan.FAN(num_modules=1)
    fan._jit = jax.jit(lambda p, v: fan.module.apply(p, v)[-1])
    depth = jdepth.DepthPredictor(layers=LAYERS)
    depth._jit = jax.jit(lambda p, v: depth.module.apply(p, v))
    s3fd = jsfd.S3FD()
    blaze = jbf.BlazeFaceNet()
    return {
        "fan": (fan, _np(fan.init_params(jax.random.PRNGKey(0)))),
        "depth": (depth, _np(depth.init_params(jax.random.PRNGKey(1)))),
        "sfd": (jax.jit(s3fd.apply), _np(s3fd.init(jax.random.PRNGKey(2), jnp.zeros((1, 64, 64, 3))))),
        "blazeface": (jax.jit(blaze.apply), _np(blaze.init(jax.random.PRNGKey(3), jnp.zeros((1, 128, 128, 3))))),
    }


def _sfd_heads_of(apply, params, u8):
    x = jnp.asarray(u8, jnp.float32)[..., ::-1] - jsfd.BGR_MEANS
    return apply(params, x)


def test_fan_heatmaps_and_depth_match_jax(nets):
    fan, fp = nets["fan"]
    crops = np.random.default_rng(0).uniform(0, 1, (2, 256, 256, 3)).astype(np.float32)
    net = tfan.make_fan(state_dict=net_state_dict_from_flax("fan", fp)).net
    with torch.no_grad():
        got = net(torch.from_numpy(crops).permute(0, 3, 1, 2))[-1].permute(0, 2, 3, 1).numpy()
    _close(got, fan._jit(fp, crops))
    depth, dp = nets["depth"]
    inp = np.random.default_rng(1).uniform(0, 1, (2, 256, 256, 71)).astype(np.float32)
    dnet = tdepth.make_depth(state_dict=net_state_dict_from_flax("depth", dp)).net
    assert tdepth.layers_of(dnet.state_dict()) == LAYERS
    with torch.no_grad():
        _close(dnet(torch.from_numpy(inp).permute(0, 3, 1, 2)).numpy(), depth._jit(dp, inp))


def test_fan_landmarks_with_depth_match_jax(nets):
    """The whole-image box, FAN, the heatmap decode and the depth net's z."""
    (fan, fp), (depth, dp) = nets["fan"], nets["depth"]
    images = _images(2, 64, 2)
    want = fan.get_landmarks(fp, jnp.asarray(images), depth=depth, depth_params=dp)
    tf = tfan.make_fan(state_dict=net_state_dict_from_flax("fan", fp))
    td = tdepth.make_depth(state_dict=net_state_dict_from_flax("depth", dp))
    got = tf.get_landmarks(torch.from_numpy(images), depth=td)
    assert got.shape == want.shape == (2, 68, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got[..., :2], want[..., :2])
    _close(got[..., 2], want[..., 2])


def test_s3fd_heads_and_detect_match_jax(nets):
    apply, params = nets["sfd"]
    u8 = np.random.default_rng(3).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    det = tsfd.make_sfd(net_state_dict_from_flax("sfd", params))
    with torch.no_grad():
        for (cj, rj), (ct, rt) in zip(_sfd_heads_of(apply, params, u8), det.heads(u8)):
            _close(ct.permute(0, 2, 3, 1).numpy(), cj)
            _close(rt.permute(0, 2, 3, 1).numpy(), rj)
    jdet = jsfd.SFDDetector(params=params)
    for got, want in zip(det.detect(u8), jdet.detect(u8)):
        assert len(want) > 0
        _close(got, want)


def test_blazeface_raw_and_detect_match_jax(nets):
    apply, params = nets["blazeface"]
    u8 = np.random.default_rng(4).integers(0, 256, (2, 128, 160, 3), dtype=np.uint8)
    det = tbf.make_blazeface(net_state_dict_from_flax("blazeface", params), min_score_thresh=0.0)
    crops, _ = det.preprocess(u8)
    rb, rs = apply(params, jnp.asarray(crops, jnp.float32))
    tb, ts = det.raw(crops)
    _close(tb, rb)
    _close(ts, rs)
    jdet = jbf.BlazeFaceDetector(params=params, min_score_thresh=0.0)
    jdet._fwd = apply
    for got, want in zip(det.detect(u8), jdet.detect(u8)):
        assert len(want) > 0
        _close(got, want)


def test_make_align_fn_end_to_end_matches_jax(nets, monkeypatch):
    """SFD boxes (its anchors: the regressors zeroed), FAN crops per box in
    one forward (JAX: one per image), the depth net, the POS warp: the same
    aligned crops. The JAX facade builds its nets at full size; here it
    builds the small forms."""
    (_, fp), (_, dp), (_, sp) = nets["fan"], nets["depth"], nets["sfd"]
    monkeypatch.setattr(jalign, "FAN", lambda: jfan.FAN(num_modules=1))
    monkeypatch.setattr(jalign, "DepthPredictor", lambda: jdepth.DepthPredictor(layers=LAYERS))
    sp = jax.tree_util.tree_map(lambda a: a, sp)
    for name in sp["params"]:
        if name.endswith("_mbox_loc"):
            sp["params"][name] = {k: np.zeros_like(v) for k, v in sp["params"][name].items()}
    images = _images(2, 64, 5)
    want = np.asarray(jalign.make_align_fn(fp, detector="sfd", detector_params=sp,
                                           depth_params=dp)(jnp.asarray(images)))
    align = talign.make_align_fn(net_state_dict_from_flax("fan", fp), detector="sfd",
                                 detector_state=net_state_dict_from_flax("sfd", sp),
                                 depth_state=net_state_dict_from_flax("depth", dp), device="cpu")
    align.timer = talign.StageTimer("cpu")
    got = align(torch.from_numpy(images)).numpy()
    assert got.shape == want.shape == (2, 224, 224, 3)
    np.testing.assert_array_equal(got, want)
    assert not align.timer.counts.get("unusable boxes") and not align.timer.counts.get("detector misses")


@pytest.mark.parametrize("name", ["sfd", "blazeface", "fan", "depth"])
def test_reference_checkpoint_round_trip(nets, name, tmp_path):
    """The port's random-init net saved in the reference checkpoint's layout:
    the JAX reader and the port's reader give the same outputs."""
    path = tmp_path / f"{name}.pth"
    rng = np.random.default_rng(6)
    if name == "sfd":
        net = init_predictor_(tsfd.S3FD(), 7)
        torch.save(net.state_dict(), path)
        apply, _ = nets["sfd"]
        u8 = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
        want = _sfd_heads_of(apply, jsfd.convert_torch_weights(str(path)), u8)
        with torch.no_grad():
            got = tsfd.make_sfd(tsfd.read_reference_state_dict(path)).heads(u8)
        for (cj, rj), (ct, rt) in zip(want, got):
            _close(ct.permute(0, 2, 3, 1).numpy(), cj)
            _close(rt.permute(0, 2, 3, 1).numpy(), rj)
    elif name == "blazeface":
        net = init_predictor_(tbf.BlazeFaceNet(), 8)
        torch.save(net.state_dict(), path)
        apply, _ = nets["blazeface"]
        crops = rng.uniform(-1, 1, (2, 128, 128, 3)).astype(np.float32)
        rb, rs = apply(jbf.convert_torch_weights(str(path)), jnp.asarray(crops))
        tb, ts = tbf.make_blazeface(tbf.read_reference_state_dict(path)).raw(crops)
        _close(tb, rb)
        _close(ts, rs)
    elif name == "fan":
        net = init_predictor_(tfan.FANNet(1), 9)
        torch.save({"state_dict": net.state_dict()}, path)
        fan, _ = nets["fan"]
        crops = rng.uniform(0, 1, (2, 256, 256, 3)).astype(np.float32)
        want = fan._jit(jfan.convert_torch_weights(str(path), num_modules=1), crops)
        with torch.no_grad():
            got = tfan.make_fan(state_dict=tfan.read_reference_state_dict(path)).net(
                torch.from_numpy(crops).permute(0, 3, 1, 2))[-1]
        _close(got.permute(0, 2, 3, 1).numpy(), want)
    else:
        net = init_predictor_(tdepth.ResNetDepth(LAYERS), 10)
        torch.save({"state_dict": {f"module.{k}": v for k, v in net.state_dict().items()}}, path)
        depth, _ = nets["depth"]
        inp = rng.uniform(0, 1, (2, 256, 256, 71)).astype(np.float32)
        want = depth._jit(jdepth.convert_torch_weights(str(path), layers=LAYERS), inp)
        with torch.no_grad():
            got = tdepth.make_depth(state_dict=tdepth.read_reference_state_dict(path)).net(
                torch.from_numpy(inp).permute(0, 3, 1, 2))
        _close(got.numpy(), want)
