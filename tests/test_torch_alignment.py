"""Parity of the port's alignment host math and decoding with the JAX
package's (``gan_control_tpu/alignment``), on the same seeded inputs.

The numpy/PIL code (POS, the 68 -> 5 map, the similarity warp, BlazeFace's
anchors, decode and blending NMS, the folder sidecars) is a copy: exact.
The tensor ops that replace numpy loops (FAN's heatmap decode, the gaussian
heatmaps, the SFD greedy NMS) are exact on the same inputs; the SFD anchor
decode is f32/f64 arithmetic with another exp (1e-6 of max); FAN's crop is
another bilinear resize (1e-6 of max). Then the facade's rules: the
fallback's warning and values (a bicubic resize in f32, 1e-5 of max), its ``ValueError``s, and the port's warning
on a detector miss and on a box that gives no crop window.
"""

import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gan_control_tpu import alignment as jalign
from gan_control_tpu.alignment import align_math as jmath
from gan_control_tpu.alignment import blazeface as jbf
from gan_control_tpu.alignment import depth as jdepth
from gan_control_tpu.alignment import fan as jfan
from gan_control_tpu.alignment import folder as jfolder
from gan_control_tpu.alignment import sfd as jsfd

from gan_control_torch import alignment as talign
from gan_control_torch.alignment import align_math as tmath
from gan_control_torch.alignment import blazeface as tbf
from gan_control_torch.alignment import depth as tdepth
from gan_control_torch.alignment import fan as tfan
from gan_control_torch.alignment import folder as tfolder
from gan_control_torch.alignment import sfd as tsfd


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch thread: the suite runs six workers on the box's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(float(np.abs(want).max()), 1e-12))


def _faces(n, size, seed):
    """Smooth images and 68 landmarks spread like a face's around the centre."""
    rng = np.random.default_rng(seed)
    small = rng.uniform(-1, 1, (n, 8, 8, 3)).astype(np.float32)
    images = np.asarray(jax.image.resize(jnp.asarray(small), (n, size, size, 3), "linear"))
    lms = size / 2 + rng.normal(0, size / 6, (n, 68, 2))
    return images, lms.astype(np.float32)


# ---------------------------------------------------------------------------
# the similarity warp
# ---------------------------------------------------------------------------


def test_pos_and_68_to_5_equal_jax():
    rng = np.random.default_rng(0)
    lm68 = rng.uniform(0, 256, (68, 2))
    np.testing.assert_array_equal(tmath.make_68_to_5(lm68), jmath.make_68_to_5(lm68))
    xp, x = rng.normal(size=(2, 5)) * 50, rng.normal(size=(3, 5))
    (tt, ts), (jt, js) = tmath.POS(xp, x), jmath.POS(xp, x)
    np.testing.assert_array_equal(tt, jt)
    assert ts == js
    np.testing.assert_array_equal(tmath.default_lm3d(), jmath.default_lm3d())


@pytest.mark.parametrize("size", [64, 256])
def test_align_tensor_images_gives_the_jax_crops(size):
    """uint8-exact crops (in [-1, 1]) on the same landmarks; the port's
    uint8 route returns each image's POS scale."""
    images, lms = _faces(3, size, 1)
    want = jmath.align_tensor_images(images, lms)
    got = tmath.align_tensor_images(images, lms)
    assert got.shape == want.shape == (3, 224, 224, 3)
    np.testing.assert_array_equal(got, want)
    aligned, scales = tmath.align_u8_images(tmath.to_u8(images), lms)
    np.testing.assert_array_equal(aligned, want)
    for lm, s in zip(lms, scales):
        h0 = size
        lm5 = jmath.make_68_to_5(lm)
        _, js = jmath.POS(np.stack([lm5[:, 0], h0 - 1 - lm5[:, 1]], 1).T, jmath.default_lm3d().T)
        assert s == js


# ---------------------------------------------------------------------------
# FAN's geometry and heatmap decode, the depth net's heatmaps
# ---------------------------------------------------------------------------


def test_decode_heatmaps_equals_jax():
    """Random heatmaps with peaks planted on every border and on ties with
    a neighbour: the same argmax, shift and +0.5."""
    rng = np.random.default_rng(2)
    hm = rng.normal(size=(2, 64, 64, 68)).astype(np.float32)
    peaks = [(0, 10), (63, 5), (7, 0), (9, 63), (0, 0), (63, 63), (30, 30), (31, 40)]
    for li, (y, x) in enumerate(peaks):
        hm[0, y, x, li] = 10.0
    hm[0, 30, 31, 6] = hm[0, 30, 29, 6] = 3.0  # equal neighbours: no shift in x
    hm[1, 12, 12, 0] = hm[1, 12, 40, 0] = 10.0  # two maxima: the first wins
    want = jfan.decode_heatmaps(hm)
    got = tfan.decode_heatmaps(torch.from_numpy(hm).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_array_equal(got, want)


def test_box_geometry_equals_jax():
    for box in ([0, 0, 512, 512], [10.5, 20.25, 300.0, 280.0], [-30, -40, 60, 50]):
        (tc, ts), (jc, js) = tfan.box_to_center_scale(box), jfan.box_to_center_scale(box)
        np.testing.assert_array_equal(tc, jc)
        assert ts == js
        for pt in ([1, 1], [256, 256], [17.3, 100.9]):
            for invert in (False, True):
                np.testing.assert_array_equal(tfan._transform_pt(pt, tc, ts, 256.0, invert),
                                              jfan._transform_pt(pt, jc, js, 256.0, invert))


@pytest.mark.parametrize("box", [None, [4, 6, 50, 58], [-10, 20, 40, 70]])
def test_fan_crop_equals_jax(box):
    images, _ = _faces(2, 64, 3)
    x01 = images * 0.5 + 0.5
    center, scale = jfan.box_to_center_scale(box or (0.0, 0.0, 64, 64))
    want = np.asarray(jfan.FAN(num_modules=1)._crop(x01, center, scale))
    got = tfan.crop(torch.from_numpy(x01).permute(0, 3, 1, 2), center, scale).permute(0, 2, 3, 1).numpy()
    _close(got, want, 1e-6)


def test_gaussian_heatmaps_equal_jax():
    """Points inside, on and past every edge (the reference's 1-based window
    arithmetic), x <= 0 (skipped) and far outside."""
    rng = np.random.default_rng(4)
    pts = rng.uniform(-12, 268, (2, 68, 2))
    pts[0, :10] = [[0.0, 5], [-3, 100], [255.5, 1], [262, 3], [1, -5.5], [0.5, 0.5], [6.9, 250],
                   [270, 270], [128, 262.9], [3.2, -6.1]]
    want = jdepth.draw_gaussian_heatmaps(pts)
    got = tdepth.draw_gaussian_heatmaps(torch.from_numpy(pts)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tdepth._gaussian_patch(), jdepth._gaussian_patch())


# ---------------------------------------------------------------------------
# the detectors' decoding and NMS on crafted candidates
# ---------------------------------------------------------------------------


def _candidates(n, seed, ties=False):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 200, (n, 2))
    wh = rng.uniform(5, 60, (n, 2))
    scores = rng.uniform(0, 1, n)
    if ties:
        scores[::3] = 1.0
    return np.concatenate([xy, xy + wh, scores[:, None]], axis=1)


@pytest.mark.parametrize("ties", [False, True])
def test_sfd_nms_keeps_the_jax_set(ties):
    for seed, n in ((5, 1), (6, 40), (7, 400)):
        dets = _candidates(n, seed, ties)
        assert tsfd.nms(dets, 0.3) == jsfd.nms(dets, 0.3)
    assert tsfd.nms(np.zeros((0, 5))) == jsfd.nms(np.zeros((0, 5))) == []


def test_sfd_decode_matches_jax():
    rng = np.random.default_rng(8)
    loc = rng.normal(size=(50, 4)).astype(np.float32)
    priors = np.concatenate([rng.uniform(0, 512, (50, 2)), np.full((50, 2), 16.0)], 1)
    want = jsfd.decode_boxes(loc, priors)
    got = tsfd.decode_boxes(torch.from_numpy(loc), torch.from_numpy(priors)).numpy()
    _close(got, want, 1e-6)


def test_blazeface_anchors_decode_and_weighted_nms_equal_jax():
    anchors = tbf.generate_anchors()
    np.testing.assert_array_equal(anchors, jbf.generate_anchors())
    rng = np.random.default_rng(9)
    raw = rng.normal(0, 20, (2, 896, 16)).astype(np.float32)
    np.testing.assert_array_equal(tbf.decode_boxes(raw, anchors), jbf.decode_boxes(raw, anchors))
    dets = np.concatenate([tbf.decode_boxes(raw, anchors)[0, :200],
                           rng.uniform(0, 1, (200, 1)).astype(np.float32)], axis=1)
    np.testing.assert_array_equal(tbf.weighted_nms(dets), jbf.weighted_nms(dets))
    img = rng.integers(0, 256, (96, 160, 3), dtype=np.uint8)
    (tc, ts), (jc, js) = tbf.resize_and_crop_image(img), jbf.resize_and_crop_image(img)
    np.testing.assert_array_equal(tc, jc)
    assert ts == js


# ---------------------------------------------------------------------------
# sidecar detections and the facade's rules
# ---------------------------------------------------------------------------


def test_folder_detector_equals_jax(tmp_path):
    np.save(tmp_path / "a.npy", np.array([1.0, 2.0, 30.0, 40.0, 0.9]))
    np.save(tmp_path / "b.npy", np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.float32))
    np.save(tmp_path / "c.npy", np.zeros((0, 5)))
    torch.save(torch.tensor([[3.0, 4.0, 50.0, 60.0]]), tmp_path / "d.pth")
    (tmp_path / "e.t7").write_bytes(b"lua")
    paths = [tmp_path / f"{n}.png" for n in "abcd"]
    for got, want in zip(tfolder.FolderDetector().detect(paths), jfolder.FolderDetector().detect(paths)):
        np.testing.assert_array_equal(got, want)
    for name, err in (("e", ValueError), ("f", FileNotFoundError)):
        for det in (tfolder.FolderDetector(), jfolder.FolderDetector()):
            with pytest.raises(err):
                det.detect_from_path(tmp_path / f"{name}.png")
    with pytest.raises(ValueError):
        tfolder.FolderDetector().detect([np.zeros((4, 4, 3))])


@pytest.fixture
def logged():
    """The messages the port's alignment logger emits during a test."""
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger = logging.getLogger("gan_control_torch.alignment")
    logger.addHandler(handler)
    yield lambda: " ".join(r.getMessage() for r in records)
    logger.removeHandler(handler)


def test_fallback_warns_and_equals_jax(logged):
    images, _ = _faces(2, 64, 10)
    fn = talign.make_align_fn(None)
    assert "alignment-FREE bicubic" in logged()
    want = np.asarray(jalign.make_align_fn(None)(jnp.asarray(images)))
    # f32 bicubic taps summed in another order (a resize matrix in JAX): ~1 ulp of each output
    _close(fn(torch.from_numpy(images)).numpy(), want, 1e-5)


def test_facade_rejects_what_jax_rejects():
    for kw in ({"detector": "sfd", "detector_state": {}}, {"depth_state": {}}):
        with pytest.raises(ValueError, match="no FAN"):
            talign.make_align_fn(None, **kw)
    with pytest.raises(ValueError, match="no FAN"):
        jalign.make_align_fn(None, depth_params={})
    with pytest.raises(ValueError, match="unknown detector"):
        talign.make_detect_fn("mtcnn", {}, device="cpu")
    with pytest.raises(ValueError, match="unknown detector"):
        jalign.make_detect_fn("mtcnn", None)


def test_a_miss_and_an_unusable_box_warn_and_take_the_whole_image(logged):
    """The detector's None (a miss) and a box off the frame both become the
    whole-image box, each with a warning naming the image; the landmarks
    are then those of no boxes at all."""
    images, _ = _faces(3, 64, 11)
    fan = tfan.make_fan(1, seed=0)
    boxes = [None, np.array([1e4, 1e4, 2e4, 2e4]), np.array([0.0, 0.0, 64.0, 64.0])]
    aligner = talign.Aligner(fan, detect=lambda images, timer=None: boxes)
    aligner.timer = talign.StageTimer("cpu")
    got = aligner(torch.from_numpy(images))
    out = logged()
    assert "no face in image 0" in out and "image 1 of the batch gives no crop window" in out
    assert aligner.timer.counts["detector misses"] == 1 and aligner.timer.counts["unusable boxes"] == 1
    want = talign.Aligner(fan)(torch.from_numpy(images))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert tfan.usable_box([0, 0, 64, 64], 64, 64) and not tfan.usable_box([5, 5, 5, 9], 64, 64)
    assert not tfan.usable_box([0, 0, np.inf, 9], 64, 64) and not tfan.usable_box([0, 0, 1e4, 9], 64, 64)
    assert tfan.usable_box([-64, -192, 448, 320], 64, 64) and not tfan.usable_box([-9, -9, -1, 5], 64, 64)
