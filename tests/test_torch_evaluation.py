"""The port's evaluation modules against the JAX package: separability
(statistics, impostor pairs, and ``calc_separability`` with ArcFace on a
size-32 G), disentanglement, the grids and matrices, the image helpers, the
annotated attribute images, the PIL plots, the ``Tracker`` and the
threshold-calibration command line (both packages' ``main`` on one config,
ESR-9 loaded by both from one reference checkpoint).

Every random input is drawn once with numpy (or by the JAX function, and
then handed to the port): latents, injection noise, parameters. ArcFace
runs at random init conditioned as in ``tests/test_torch_predictors.py``
(seeded batch-norm statistics, conv weights halved: at raw init it is
chaotic in f32); its separability statistics are held to 1e-4 of their
largest entry. Statistics of the same matrix are exact.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gan_control_tpu.evaluation import attribute_evals as j_attr
from gan_control_tpu.evaluation import disentanglement as j_dis
from gan_control_tpu.evaluation import generation as j_gen
from gan_control_tpu.evaluation import separability as j_sep
from gan_control_tpu.evaluation.tracker import Tracker as JTracker
from gan_control_tpu.losses.contrastive import pairwise_sq_l2 as j_sq_l2
from gan_control_tpu.models.generator import Generator as JGenerator
from gan_control_tpu.utils import image_utils as j_img

from gan_control_torch.evaluation import attribute_evals as t_attr
from gan_control_torch.evaluation import disentanglement as t_dis
from gan_control_torch.evaluation import generation as t_gen
from gan_control_torch.evaluation import separability as t_sep
from gan_control_torch.evaluation.tracker import Tracker as TTracker
from gan_control_torch.losses.contrastive import pairwise_sq_l2 as t_sq_l2
from gan_control_torch.losses.predictors import predictor_module
from gan_control_torch.models.generator import Generator as TGenerator
from gan_control_torch.utils import image_utils as t_img
from gan_control_torch.utils import plotting
from gan_control_torch.utils.flax_bridge import flax_to_state_dict, predictor_state_dict_from_flax

from test_torch_predictors import TC, _condition_flax, _jax_module, _port_model

REL = 1e-4
STYLE = 32
CHUNK = (16, 32)


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch thread for this file: the suite runs six workers on the
    box's cores, and a pool of one thread per core in each of them thrashes
    (this file's tests ran ~20x slower than alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, what, rel=REL):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rel * scale, err_msg=what)


@pytest.fixture(scope="module")
def generators():
    """A size-32 JAX G (noise weights drawn non-zero) and the port's G with
    its parameters."""
    jg = JGenerator(size=32, style_dim=STYLE, n_mlp=2, max_channels=16)
    gp = jax.tree_util.tree_map(np.asarray, jg.init(
        {"params": jax.random.PRNGKey(1), "noise": jax.random.PRNGKey(2)}, [jnp.zeros((1, STYLE))]))
    rng = np.random.default_rng(3)
    for mod in gp["params"].values():
        if "noise" in mod:
            mod["noise"]["weight"] = rng.standard_normal(1).astype(np.float32)
    tg = TGenerator(size=32, style_dim=STYLE, n_mlp=2, max_channels=16)
    tg.load_state_dict(flax_to_state_dict(gp), strict=True)
    return jg, gp, tg.eval()


# ---------------------------------------------------------------------------
# separability
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_separability_stats_and_impostor_pairs_equal_jax(seed):
    d = np.random.default_rng(seed).random((9, 9)).astype(np.float32)
    got, want = t_sep.separability_stats(d), j_sep.separability_stats(d)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in (1, 4, 20):
        np.testing.assert_array_equal(t_sep.closest_impostor_pairs(d, k),
                                      j_sep.closest_impostor_pairs(d, k))


def test_make_paired_latents_copies_the_chunk():
    z = np.random.default_rng(4).standard_normal((6, STYLE)).astype(np.float32)
    got = t_sep.make_paired_latents(6, CHUNK, STYLE, z=torch.from_numpy(z)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.asarray(z).at[1::2, 16:32].set(z[0::2, 16:32])))
    drawn = t_sep.make_paired_latents(6, CHUNK, STYLE, torch.Generator().manual_seed(0)).numpy()
    np.testing.assert_array_equal(drawn[1::2, 16:32], drawn[0::2, 16:32])
    assert not np.allclose(drawn[1::2, :16], drawn[0::2, :16])


def test_calc_separability_with_arcface_matches_jax(generators):
    """The JAX function draws the paired latents (then handed to the port);
    both sides generate each batch with the same noise and run the same
    ArcFace; every statistic to 1e-4 of its largest entry, the worst pairs
    equal."""
    jg, gp, tg = generators
    mod = _jax_module("embedding_loss")
    model = mod.make_model(TC["embedding_loss"])
    params = mod.init_params(model, jax.random.PRNGKey(5))
    params = _condition_flax("embedding_loss", jax.tree_util.tree_map(np.asarray, params), seed=5)
    arcface = _port_model("embedding_loss", predictor_state_dict_from_flax("embedding_loss", params))
    n, batch = 8, 4
    rng = np.random.default_rng(6)
    noise = [[rng.standard_normal(s).astype(np.float32) for s in jg.noise_shapes(batch)]
             for _ in range(n // batch)]
    calls = []

    def j_generate(z, key):
        calls.append(key)
        img, _ = jg.apply(gp, [z], noise=[jnp.asarray(p) for p in noise[len(calls) - 1]])
        return img

    j_features = jax.jit(lambda imgs: mod.features(model, params, imgs))
    want, latents = j_sep.calc_separability(
        j_generate, j_features, j_sq_l2, jax.random.PRNGKey(7), num_of_samples=n,
        batch_size=batch, same_chunk=CHUNK, style_dim=STYLE, return_latents=True)

    def t_generate(z, gen, batch_noise):
        img, _ = tg([z], noise=batch_noise, generator=gen)
        return img

    got, t_latents = t_sep.calc_separability(
        t_generate, arcface, t_sq_l2, seed=7, num_of_samples=n, batch_size=batch,
        same_chunk=CHUNK, style_dim=STYLE, return_latents=True,
        latents=torch.from_numpy(np.asarray(latents)),
        noise=[[torch.from_numpy(p) for p in b] for b in noise])
    np.testing.assert_array_equal(t_latents.numpy(), np.asarray(latents))
    assert len(got) == len(want) == 1
    for k in ("same", "not_same", "all_not_same"):
        _close(got[0][k], want[0][k], k)
    np.testing.assert_array_equal(got[0]["worst_pairs"], want[0]["worst_pairs"])


def test_calc_separability_draws_fresh_noise_per_batch():
    """Without noise passed in, each batch gets its own generator."""
    seeds = []

    def generate(z, gen, noise):
        assert noise is None
        seeds.append(gen.initial_seed())
        return z[:, None, None, :].expand(-1, 2, 2, -1)

    st = t_sep.calc_separability(generate, lambda imgs: [imgs[:, 0, 0]], t_sq_l2, seed=3,
                                 num_of_samples=12, batch_size=4, same_chunk=CHUNK, style_dim=STYLE)
    assert len(set(seeds)) == 3
    assert st[0]["same"].shape == (6,) and st[0]["all_not_same"].shape == (30,)


# ---------------------------------------------------------------------------
# disentanglement
# ---------------------------------------------------------------------------


def test_disentanglement_on_the_jax_synthetic_case():
    """The JAX test's transparent 'generator' (pixels = the latent): the
    JAX function's own draws, replayed from its key splits and passed to
    the port, give the same scores; varied groups read ~1, frozen ones 0."""
    style_dim, set_size, num_sets = 8, 8, 3
    groups = {"a": (0, 4), "b": (4, 8)}
    attribute_fns = {"a": lambda imgs: np.asarray(imgs[:, 0, 0, 0:4]),
                     "b": lambda imgs: np.asarray(imgs[:, 0, 0, 4:8])}
    rng = jax.random.PRNGKey(0)
    want = j_dis.disentanglement_scores(
        lambda z: jnp.tile(z[:, None, None, :], (1, 2, 2, 1)), attribute_fns, groups, rng,
        num_sets=num_sets, set_size=set_size, style_dim=style_dim)
    k_base, rng = jax.random.split(rng)
    free_z = np.asarray(jax.random.normal(k_base, (set_size * 2, style_dim)))
    sets = {}
    for group, (s, e) in groups.items():
        for _ in range(num_sets):
            rng, k_fix, k_var = jax.random.split(rng, 3)
            z = jnp.broadcast_to(jax.random.normal(k_fix, (style_dim,)), (set_size, style_dim))
            sets.setdefault(group, []).append(
                torch.from_numpy(np.asarray(z.at[:, s:e].set(jax.random.normal(k_var, (set_size, e - s))))))
    got = t_dis.disentanglement_scores(
        lambda z: z[:, None, None, :].expand(-1, 2, 2, -1).numpy(), attribute_fns, groups,
        num_sets=num_sets, set_size=set_size, style_dim=style_dim,
        free_z=torch.from_numpy(free_z), set_latents=sets)
    for varied in groups:
        for attr in groups:
            np.testing.assert_allclose(got[varied][attr], want[varied][attr], rtol=1e-9, atol=1e-12)
        assert got[varied][varied] > 0.5
        assert got[varied][[a for a in groups if a != varied][0]] == 0.0
    sig = {"a": 0.9, "b": 0.3, "c": 0.45}
    assert t_dis.ds_index(sig, "a") == pytest.approx(j_dis.ds_index(sig, "a"), rel=1e-12)
    vecs = np.random.default_rng(1).standard_normal((7, 3))
    assert t_dis.all_vs_all_mean_distance(vecs) == j_dis.all_vs_all_mean_distance(vecs)
    drawn = t_dis.disentanglement_scores(lambda z: z.numpy(), {"a": lambda x: x[:, :4]}, {"a": (0, 4)},
                                         torch.Generator().manual_seed(0), num_sets=2, set_size=4,
                                         style_dim=style_dim)
    assert drawn["a"]["a"] > 0


# ---------------------------------------------------------------------------
# grids and matrices
# ---------------------------------------------------------------------------


def test_gen_grid_images_match_jax(generators):
    """Clipped [0, 1] images from z and noise passed in."""
    jg, gp, tg = generators
    rng = np.random.default_rng(8)
    z = rng.standard_normal((3, STYLE)).astype(np.float32)
    noise = [rng.standard_normal(s).astype(np.float32) for s in jg.noise_shapes(3)]
    want = j_gen.gen_grid_images(jg, gp, jnp.asarray(z), noise=[jnp.asarray(n) for n in noise])
    got = t_gen.gen_grid_images(tg, torch.from_numpy(z), noise=[torch.from_numpy(n) for n in noise])
    assert float(got.min()) == 0.0 or float(got.max()) == 1.0
    _close(got.numpy(), want, "grid images")
    mat = t_gen.gen_matrix_images(tg, torch.Generator().manual_seed(0), ids_in_row=3, pose_in_col=2,
                                  same_chunk=CHUNK, style_dim=STYLE)
    assert mat.shape == (6, 32, 32, 3) and 0.0 <= float(mat.min()) and float(mat.max()) <= 1.0


# ---------------------------------------------------------------------------
# image helpers, annotations, plots
# ---------------------------------------------------------------------------


def test_image_helpers_equal_jax():
    rng = np.random.default_rng(9)
    u8 = (rng.random((48, 40, 3)) * 255).astype(np.uint8)
    np.testing.assert_array_equal(t_img.write_text_on_image(u8, "42.0y"),
                                  j_img.write_text_on_image(u8, "42.0y"))
    np.testing.assert_array_equal(t_img.draw_axis_on_image(u8, 20.0, -10.0, 5.0, size=12.0),
                                  j_img.draw_axis_on_image(u8, 20.0, -10.0, 5.0, size=12.0))
    imgs = rng.random((2, 16, 16, 3)).astype(np.float32) * 1.2 - 0.1
    np.testing.assert_array_equal(t_img.annotate_images(imgs, ["a", "b"]),
                                  j_img.annotate_images(imgs, ["a", "b"]))
    values = rng.random(20)
    for k in (1, 5, 20):
        for g, w in zip(t_img.get_kmin(values, k), j_img.get_kmin(values, k)):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kind", ["orientation_loss", "age_loss", "expression_loss", "hair_loss",
                                  "attribute"])
def test_annotate_attribute_images_equal_jax(kind):
    rng = np.random.default_rng(10)
    images = rng.random((3, 40, 40, 3)).astype(np.float32)
    preds = {"orientation_loss": rng.uniform(-60, 60, (3, 3)), "attribute": rng.uniform(-60, 60, (3, 3)),
             "age_loss": rng.uniform(5, 80, 3), "expression_loss": rng.integers(0, 8, 3),
             "hair_loss": rng.random((3, 3))}[kind].astype(np.float32)
    extra = rng.integers(0, 8, 3) if kind == "attribute" else None
    want = j_attr.annotate_attribute_images(kind, images, preds, extra_preds=extra)
    got = t_attr.annotate_attribute_images(kind, torch.from_numpy(images), preds, extra_preds=extra)
    assert got.dtype == np.float32
    np.testing.assert_array_equal((got * 255).round().astype(np.uint8),
                                  (want * 255).round().astype(np.uint8))


def test_calc_helpers_return_each_predictors_values():
    """The ``calc_*`` helpers go through each module's ``predict``."""
    images = np.random.default_rng(11).standard_normal((2, 64, 64, 3)).astype(np.float32)
    images = torch.from_numpy(images * 0.5)
    hop = _port_model("orientation_loss", seed=1)
    got = t_attr.calc_orientation_from_tensor_images(predictor_module("orientation_loss"), hop, images)
    np.testing.assert_array_equal(got, predictor_module("orientation_loss").predict(hop, images).numpy())
    assert got.shape == (2, 3)
    esr = _port_model("expression_loss", seed=2)
    cls = t_attr.calc_expression_from_tensor_images(predictor_module("expression_loss"), esr, images)
    assert cls.shape == (2,) and cls.dtype == np.int64


def test_pil_plots(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(12)
    a, b = rng.normal(0, 1, 500), rng.normal(2, 0.5, 300)
    path = plotting.plot_hist([a, b], title="t", labels=["a", "b"], xlabel="x", bins=20,
                              percentiles=(0.2, 0.5), save_path=tmp_path / "h.jpg")
    assert Image.open(path).size == (plotting.WIDTH, plotting.HEIGHT)
    plotting.plot_hist([np.full(4, 3.0)], min_lim=0.0, save_path=tmp_path / "flat.png")
    path = plotting.plot_bar([3, 0, 7], ["x", "y", "z"], title="bars", save_path=tmp_path / "b.png")
    img = np.asarray(Image.open(path))
    col = [int((plotting.BOX[0] + (k + 0.5) * (plotting.BOX[2] - plotting.BOX[0]) / 3)) for k in range(3)]
    # the bars' heights are in the ratio of the counts
    heights = [int((img[plotting.BOX[1]:plotting.BOX[3], c] == plotting.COLORS[0]).all(-1).sum())
               for c in col]
    assert heights[1] == 0 and heights[2] > heights[0] > 0
    assert abs(heights[2] / heights[0] - 7 / 3) < 0.05


def test_gif_from_grids_frames_match_jax(tmp_path):
    from PIL import Image, ImageSequence

    rng = np.random.default_rng(13)
    frames = [rng.uniform(0, 1, (5, 8, 8, 3)).astype(np.float32) for _ in range(3)]
    t_img.save_gif_from_grids(frames, tmp_path / "t.gif", nrow=2, duration_ms=200)
    j_img.save_gif_from_grids(frames, tmp_path / "j.gif", nrow=2, duration_ms=200)
    got, want = (Image.open(tmp_path / f"{n}.gif") for n in "tj")
    assert got.n_frames == want.n_frames == 3 and got.info["duration"] == want.info["duration"] == 200
    for g, w in zip(ImageSequence.Iterator(got), ImageSequence.Iterator(want)):
        np.testing.assert_array_equal(np.asarray(g.convert("RGB")), np.asarray(w.convert("RGB")))


def test_plot_graph_annotates_min_and_last_as_jax(tmp_path, monkeypatch):
    import matplotlib.axes
    from PIL import Image, ImageDraw

    from gan_control_tpu.utils import plotting as j_plot

    texts = {"jax": [], "port": []}
    j_annotate, t_text = matplotlib.axes.Axes.annotate, ImageDraw.ImageDraw.text

    def annotate(ax, text, *a, **k):
        texts["jax"].append(text)
        return j_annotate(ax, text, *a, **k)

    def text(draw, xy, value, *a, **k):
        texts["port"].append(value)
        return t_text(draw, xy, value, *a, **k)

    monkeypatch.setattr(matplotlib.axes.Axes, "annotate", annotate)
    monkeypatch.setattr(ImageDraw.ImageDraw, "text", text)
    values, steps = [31.5, 22.25, 19.125, 24.0], [0, 100, 200, 300]
    j_plot.plot_graph(values, steps, title="fid", ylabel="FID", save_path=tmp_path / "j.png")
    path = plotting.plot_graph(values, steps, title="fid", ylabel="FID", save_path=tmp_path / "t.png")
    assert texts["jax"] == ["min 19.125", "last 24.000"]
    assert [t for t in texts["port"] if t.startswith(("min ", "last "))] == texts["jax"]
    assert Image.open(path).size == (plotting.WIDTH, plotting.HEIGHT)


def test_plot_error_bar(tmp_path):
    from PIL import Image

    means, stds = [1.0, 3.0, 2.0], [0.5, 1.0, 0.25]
    path = plotting.plot_error_bar(means, stds, ["a", "b", "c"], title="e", ylabel="v",
                                   save_path=tmp_path / "e.png")
    img = np.asarray(Image.open(path))
    assert img.shape == (plotting.HEIGHT, plotting.WIDTH, 3)
    slot = (plotting.BOX[2] - plotting.BOX[0]) / 3
    # each bar's vertical extent, in the plot's colour, in the ratio of the stds
    spans = []
    for k in range(3):
        col = img[plotting.BOX[1]:plotting.BOX[3], int(plotting.BOX[0] + (k + 0.5) * slot)]
        rows = np.flatnonzero((col == plotting.COLORS[0]).all(-1))
        spans.append(rows.max() - rows.min())
    assert abs(spans[1] / spans[0] - 2.0) < 0.1 and abs(spans[2] / spans[0] - 0.5) < 0.1


# ---------------------------------------------------------------------------
# the Tracker
# ---------------------------------------------------------------------------


def _drive(tracker, sep):
    out = []
    tracker.mark_start_iter()
    tracker.mark_start_iter()
    out.append(tracker.register_fid(100, 30.0))
    tracker.register_separability(100, "embedding_loss", sep)
    tracker.evaluation_dict["orientation/yaw_std"] = 4.5
    out.append(tracker.write_stats(100, extra={"g_loss": 1.5}))
    out.append(tracker.register_fid(200, 30.0))
    out.append(tracker.is_best_fid())
    out.append(tracker.write_stats(200, extra={"d_loss": np.float32(2.25)}))
    out.append(tracker.register_fid(300, 40.0))
    out.append(tracker.write_stats(300))
    out.append(tracker.save_bucket_images(300, "embedding_loss", np.full((4, 8, 8, 3), 0.5, np.float32)))
    return out


def _strip(rec):
    return {k: v for k, v in rec.items() if not k.startswith("iter_time_")}


def test_tracker_writes_what_the_jax_tracker_writes(tmp_path):
    """The same calls on both Trackers: the same return values, the same
    ``metrics.jsonl`` records and ``monitor.csv`` (the header the union of
    keys, rewritten when one appears) apart from the iteration times; the
    bucket image; TensorBoard events; a profiler trace."""
    sep = [t_sep.separability_stats(np.random.default_rng(13).random((5, 5)))]
    dirs = {name: tmp_path / name for name in ("jax", "port")}
    for d in dirs.values():
        d.mkdir()
    j_out = _drive(JTracker(save_dir=dirs["jax"], csv_monitor=True), sep)
    port = TTracker(save_dir=dirs["port"], csv_monitor=True, tensorboard=True)
    t_out = _drive(port, sep)
    assert [o for o in t_out if isinstance(o, bool)] == [o for o in j_out if isinstance(o, bool)] \
        == [True, True, True, False]
    for g, w in zip(t_out, j_out):
        if isinstance(w, dict):
            assert _strip(g) == _strip(w)
    assert "iter_time_mean" in t_out[1]
    recs = {name: [_strip(json.loads(ln)) for ln in (d / "metrics.jsonl").read_text().splitlines()]
            for name, d in dirs.items()}
    assert recs["port"] == recs["jax"] and len(recs["port"]) == 3
    assert recs["port"][0]["separability/embedding_loss/l0_margin"] == pytest.approx(
        np.mean(sep[0]["not_same"]) - np.mean(sep[0]["same"]))
    import csv

    csvs = {}
    for name, d in dirs.items():
        with open(d / "monitor.csv", newline="") as f:
            rows = list(csv.DictReader(f))
        csvs[name] = [{k: v for k, v in r.items() if not k.startswith("iter_time_")} for r in rows]
    assert csvs["port"] == csvs["jax"] and len(csvs["port"]) == 3
    assert csvs["port"][0]["fid"] == "30.0" and csvs["port"][1]["g_loss"] == ""
    np.testing.assert_array_equal(np.asarray(__import__("PIL.Image").Image.open(t_out[-1])),
                                  np.asarray(__import__("PIL.Image").Image.open(j_out[-1])))
    port.close()
    assert list((dirs["port"] / "tensorboard").glob("events.out.tfevents.*"))


# ---------------------------------------------------------------------------
# the threshold-calibration command line
# ---------------------------------------------------------------------------


def test_per_layer_same_not_same_equals_jax():
    import calibrate_thresholds as j_ct
    from gan_control_tpu.losses.contrastive import pairwise_l1 as j_l1

    from gan_control_torch import calibrate_thresholds as t_ct
    from gan_control_torch.losses.contrastive import pairwise_l1 as t_l1

    rng = np.random.default_rng(14)
    layers = [rng.standard_normal(s).astype(np.float32) for s in ((12, 4, 3), (12, 6))]
    chunks = [[la[:5] for la in layers], [la[5:] for la in layers]]
    want = j_ct.per_layer_same_not_same(chunks, [j_l1, j_sq_l2], chunk=4)
    got = t_ct.per_layer_same_not_same([[torch.from_numpy(c) for c in ch] for ch in chunks],
                                       [t_l1, t_sq_l2], chunk=4)
    for g, w in zip(got, want):
        for k in w:
            _close(g[k], w[k], k, rel=1e-6)


def test_calibrate_thresholds_command_line_matches_jax(tmp_path):
    """Both packages' ``main`` on the same config: the synthetic loader (the
    same batches in both), ESR-9 loaded by both from one reference
    checkpoint, f32 at "highest"; the same histograms and the same table."""
    import calibrate_thresholds as j_ct

    from gan_control_torch import calibrate_thresholds as t_ct
    from test_torch_predictors import _save_reference_layout

    esr = _port_model("expression_loss", seed=2)
    block = dict(TC["expression_loss"], enabled=True, center_crop=None,
                 model_path=_save_reference_layout("expression_loss", esr.state_dict(), tmp_path))
    cfg = {"model_config": {"size": 96, "latent_size": 64},
           "data_config": {"data_set_name": "synthetic", "path": ""},
           "training_config": {"expression_loss": block}}
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    tables = {}
    for name, main, extra in (("jax", j_ct.main, []), ("port", t_ct.main, ["--device", "cpu"])):
        out = tmp_path / name
        assert main(["--config_path", str(tmp_path / "cfg.json"), "--loss", "expression_loss",
                     "--num_images", "8", "--batch_size", "4", "--out", str(out),
                     "--precision", "highest", *extra]) == 0
        assert len(sorted(out.glob("expression_loss_layer_*.jpg"))) == 2
        tables[name] = json.loads((out / "expression_loss_thresholds.json").read_text())
    assert tables["port"].keys() == tables["jax"].keys()
    for layer, want in tables["jax"].items():
        for kind, vals in want.items():
            for q, w in vals.items():
                assert tables["port"][layer][kind][q] == pytest.approx(w, rel=1e-4, abs=1e-6), \
                    (layer, kind, q)
