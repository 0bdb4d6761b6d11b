"""Parity of the port's phase-2a side with the JAX package: the attribute
tables and their loaders, the predictors' ``predict`` and
``controller_criterion``, ``ControlExtractor`` and the sweep's command line.

A tiny phase-1 directory (size 16, ``max_channels`` 32, 2-layer group
mappings) is written by the JAX package; both sides read it. Tables are
written by the JAX package's own code path (a pandas pickle of one row
per image) and read by both. Predictor heads get the same seeded logits;
``ControlExtractor`` holds full-size nets at random init, the JAX
parameters carried across by the bridge (Hopenet and the R-Net, batch 2).

Tolerance: the loaders and the argmax vote are exact; the heads are f32
arithmetic in another order (1e-6 of the largest entry); the extractor's
columns run a full-size net in f32 on each side (1e-4 of the largest entry,
as the predictors' layers in ``tests/test_torch_predictors.py``).
"""

import sys

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

from gan_control_tpu.data import dataframe as jdf
from gan_control_tpu.losses.predictors import arcface as jarc
from gan_control_tpu.losses.predictors import dex_age as jdex
from gan_control_tpu.losses.predictors import esr9 as jesr
from gan_control_tpu.losses.predictors import face3dmm as j3dmm
from gan_control_tpu.losses.predictors import hair_pspnet as jhair
from gan_control_tpu.losses.predictors import hopenet as jhop
from gan_control_tpu.models.factory import build_generator as j_build_generator
from gan_control_tpu.models.factory import build_group_spec as j_build_group_spec
from gan_control_tpu.utils import checkpoint as j_ckpt
from gan_control_tpu.utils.config import write_json

from gan_control_torch.data import dataframe as tdf
from gan_control_torch.losses.predictors import arcface as tarc
from gan_control_torch.losses.predictors import dex_age as tdex
from gan_control_torch.losses.predictors import esr9 as tesr
from gan_control_torch.losses.predictors import face3dmm as t3dmm
from gan_control_torch.losses.predictors import hair_pspnet as thair
from gan_control_torch.losses.predictors import hopenet as thop
from gan_control_torch.utils.flax_bridge import predictor_state_dict_from_flax

STYLE = 64
SIZE = 16


def _randn(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def tiny_model_config(losses=()):
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
                "orientation": {"place_in_mini_batch": [0, 4], "place_in_latent": [0, 32]},
                "other": {"place_in_mini_batch": [4, 8], "place_in_latent": [32, 64]},
            },
            **{loss: {"enabled": True} for loss in losses},
        },
    }


def write_phase1_dir(root, config):
    """A phase-1 directory written by the JAX package (args.json and a
    ``g_ema`` checkpoint)."""
    root.mkdir(parents=True)
    write_json(config, root / "args.json")
    gen = j_build_generator(config, j_build_group_spec(config))
    params = gen.init({"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
                      [jnp.zeros((1, STYLE))])
    j_ckpt.save_checkpoint(root / "checkpoint", {"g_ema": params}, 1)
    return root


# ---------------------------------------------------------------------------
# tables and loaders
# ---------------------------------------------------------------------------


def _jax_table(path, n=60, seed=0):
    """An attribute table as the JAX sweep writes it: one row dict per
    image, vector columns as arrays, scalar columns as floats."""
    rng = np.random.default_rng(seed)
    rows = [{
        "latents": rng.standard_normal(STYLE).astype(np.float32),
        "latents_w": rng.standard_normal(STYLE).astype(np.float32),
        "age": float(np.float32(rng.uniform(15, 75))),
        "orientation": rng.normal(size=3).astype(np.float32),
        "expression_q": float(rng.integers(0, 8)),
        "gamma3d": rng.normal(size=27).astype(np.float32),
    } for _ in range(n)]
    pd.DataFrame(rows).to_pickle(path)
    return path


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    root = tmp_path_factory.mktemp("tables")
    pkl = _jax_table(root / "attributes.pkl")
    npz = root / "attributes.npz"
    tdf.write_table(npz, tdf.read_table(pkl))
    return {"pkl": pkl, "npz": npz}


@pytest.mark.parametrize("fmt", ["pkl", "npz"])
@pytest.mark.parametrize("attribute", ["orientation", "age", "expression_q", "gamma3d"])
def test_loaders_give_the_jax_loaders_batches(tables, fmt, attribute):
    """From a JAX-written pickle (or the port's .npz of it): the same train
    and eval batches as the JAX loader for the same seed, over more than one
    epoch."""
    for train, bs in ((True, 16), (False, 50)):
        jl, jds = jdf.get_dataframe_data_loader(tables["pkl"], attribute, bs, train=train, seed=3)
        tl, tds = tdf.get_dataframe_data_loader(tables[fmt], attribute, bs, train=train, seed=3)
        assert len(tds) == len(jds)
        for _ in range(5):
            (jc, jw), (tc, tw) = next(jl), next(tl)
            np.testing.assert_array_equal(tc, jc)
            np.testing.assert_array_equal(tw, jw)
    jl, _ = jdf.get_merged_dataframe_data_loader(tables["pkl"], ["age", "orientation", "expression_q"], 8)
    tl, tds = tdf.get_merged_dataframe_data_loader(tables[fmt], ["age", "orientation", "expression_q"], 8)
    assert len(tds) == 54
    for _ in range(3):
        (jc, jw), (tc, tw) = next(jl), next(tl)
        assert set(tc) == set(jc)
        for k in jc:
            np.testing.assert_array_equal(tc[k], jc[k])
        np.testing.assert_array_equal(tw, jw)


def test_table_formats_round_trip_and_expression_is_one_hot(tables, tmp_path):
    a, b = tdf.read_table(tables["pkl"]), tdf.read_table(tables["npz"])
    assert list(a) == list(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert a["age"].dtype == np.float64 and a["orientation"].shape == (60, 3)
    # the port's .pkl is the JAX layout: the JAX dataset reads it
    pkl = tmp_path / "again.pkl"
    tdf.write_table(pkl, b)
    got = pd.read_pickle(pkl)
    want = pd.read_pickle(tables["pkl"])
    assert list(got.columns) == list(want.columns)
    for col in want.columns:
        assert type(got[col][0]) is type(want[col][0])
        assert np.shape(got[col][0]) == np.shape(want[col][0])
    ds = tdf.DataFrameDataset(tables["npz"], "expression_q")
    jds = jdf.DataFrameDataset(pkl, "expression_q")
    assert ds.controls.shape == (54, tdf.NUM_EXPRESSION_CLASSES)
    np.testing.assert_array_equal(ds.controls.sum(axis=1), 1.0)
    np.testing.assert_array_equal(ds.controls, jds.controls)


def test_attribute_column_for_and_its_errors():
    for loss, in_dim in (("age_loss", 1), ("orientation_loss", 3), ("hair_loss", 3), ("gamma_loss", 27),
                         ("recon_gamma_loss", 27), ("expression_loss", 64), ("expression_loss", 8),
                         ("expression_loss", None)):
        assert tdf.attribute_column_for(loss, in_dim) == jdf.attribute_column_for(loss, in_dim)
    for loss, in_dim in (("expression_loss", 7), ("embedding_loss", 512)):
        with pytest.raises(ValueError) as want:
            jdf.attribute_column_for(loss, in_dim)
        with pytest.raises(ValueError) as got:
            tdf.attribute_column_for(loss, in_dim)
        assert str(got.value) == str(want.value)


def test_pickle_without_pandas_raises_and_names_npz(tables, monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "pandas", None)
    with pytest.raises(ImportError, match=r"\.npz"):
        tdf.read_table(tables["pkl"])
    with pytest.raises(ImportError, match=r"\.npz"):
        tdf.write_table(tmp_path / "t.pkl", {"latents_w": np.zeros((2, 4), np.float32)})
    assert not (tmp_path / "t.pkl").exists()
    # the .npz route needs no pandas; another suffix is refused
    tdf.get_dataframe_data_loader(tables["npz"], "age", 8)
    with pytest.raises(ValueError, match="npz"):
        tdf.read_table(tmp_path / "t.csv")


# ---------------------------------------------------------------------------
# predictor heads
# ---------------------------------------------------------------------------


def test_orientation_and_age_from_logits_match_jax():
    logits = _randn((5, 3, 66), 0, 3.0)
    _close(thop.orientation_from_logits(torch.from_numpy(logits)),
           jhop.orientation_from_logits(jnp.asarray(logits)), 1e-6)
    logits = _randn((5, 101), 1, 3.0)
    _close(tdex.age_from_logits(torch.from_numpy(logits)), jdex.age_from_logits(jnp.asarray(logits)), 1e-6)


def _features_as(monkeypatch, jmod, feats):
    monkeypatch.setattr(jmod, "features", lambda model, params, images: [jnp.asarray(f) for f in feats])
    return lambda images: [torch.from_numpy(f) for f in feats]


def test_predict_of_each_head_matches_jax(monkeypatch):
    """Each module's ``predict`` on the same last layer: Hopenet and DEX
    (softmax expectations), ESR-9's vote (exact, ties to the first class),
    the hair colour (one image without hair), ArcFace and the R-Net (the
    layer itself)."""
    imgs = np.zeros((6, 8, 8, 3), np.float32)
    cases = []
    cases.append((jhop, thop, [_randn((6, 3, 66), 2, 3.0)]))
    cases.append((jdex, tdex, [_randn((6, 101), 3, 3.0)]))
    emotions = np.round(_randn((6, 9, 8), 4), 1)
    cases.append((jesr, tesr, [_randn((6, 2, 2, 4), 5), emotions]))
    mask = (np.random.default_rng(6).random((6, 16, 16, 1)) > 0.6).astype(np.float32)
    mask[2] = 0.0
    img = _randn((6, 16, 16, 3), 7, 0.5)
    cases.append((jhair, thair, [np.concatenate([img * mask, mask], axis=-1)]))
    cases.append((jarc, tarc, [_randn((6, 4, 4, 8), 8), _randn((6, 512), 9)]))
    cases.append((j3dmm, t3dmm, [_randn((6, 257), 10)]))
    for jmod, tmod, feats in cases:
        model = _features_as(monkeypatch, jmod, feats)
        want = np.asarray(jmod.predict(None, None, jnp.asarray(imgs)))
        got = tmod.predict(model, torch.from_numpy(imgs)).numpy()
        if jmod is jesr:
            np.testing.assert_array_equal(got, want)
        else:
            _close(got, want, 1e-6)
        if jmod is jhair:
            assert not got[2].any()


@pytest.mark.parametrize("jmod,tmod", [(jhop, thop), (jdex, tdex), (jesr, tesr), (jhair, thair),
                                       (jarc, tarc), (j3dmm, t3dmm)])
def test_controller_criterion_matches_jax(jmod, tmod):
    pred, target = _randn((7, 5), 11), _randn((7, 5), 12)
    _close(tmod.controller_criterion(torch.from_numpy(pred), torch.from_numpy(target)),
           jmod.controller_criterion(jnp.asarray(pred), jnp.asarray(target)), 1e-6)


# ---------------------------------------------------------------------------
# ControlExtractor and the sweep
# ---------------------------------------------------------------------------


def test_control_extractor_matches_jax():
    """Hopenet and the R-Net at full size, random JAX weights carried over:
    the same columns, in the same order, to 1e-4 of each column's max."""
    from gan_control_tpu.inference.extract_controls import ControlExtractor as JExtractor

    from gan_control_torch.inference.extract_controls import ControlExtractor as TExtractor

    tc = tiny_model_config(("orientation_loss", "recon_3d_loss"))["training_config"]
    jext = JExtractor(tc, rng=jax.random.PRNGKey(1))
    text = TExtractor(tc, device="cpu")
    for loss, (_, _, params) in jext.mods.items():
        sd = predictor_state_dict_from_flax(loss, jax.tree_util.tree_map(np.asarray, params))
        text.models[loss].load_state_dict(sd, strict=True)
    images = np.tanh(_randn((2, SIZE, SIZE, 3), 13))
    want, got = jext.extract(images), text.extract(images)
    assert list(got) == list(want) == ["orientation", "gamma3d", "expression3d", "orientation3d"]
    for k in want:
        assert got[k].dtype == np.float32
        _close(got[k], want[k], 1e-4)
    # aligned inputs (each package's alignment without FAN weights: the bicubic
    # 224 resize) before the R-Net, whose center_crop align_3d clears
    from gan_control_tpu.alignment import make_align_fn as j_make_align_fn

    from gan_control_torch.alignment import make_align_fn as t_make_align_fn

    jext = JExtractor(tc, align_fn=j_make_align_fn(None), rng=jax.random.PRNGKey(1), align_3d=True)
    text = TExtractor(tc, align_fn=t_make_align_fn(None), align_3d=True, device="cpu")
    assert text.models["recon_3d_loss"].center_crop is None
    for loss, (_, _, params) in jext.mods.items():
        sd = predictor_state_dict_from_flax(loss, jax.tree_util.tree_map(np.asarray, params))
        text.models[loss].load_state_dict(sd, strict=True)
    want, got = jext.extract(images), text.extract(images)
    assert list(got) == list(want)
    for k in want:
        _close(got[k], want[k], 1e-4)


def test_sweep_command_line_matches_the_jax_one(tmp_path, monkeypatch):
    """The port's ``make_attributes_df`` on a JAX-written phase-1 directory
    with Hopenet enabled: the JAX command line's columns, cell types and
    shapes, in .pkl and .npz alike; ``latents_w`` is the port G's mapping
    of ``latents``; with ``--align_3d`` and no FAN weights the JAX command
    line's columns too."""
    import make_attributes_df as jcli

    from gan_control_torch import make_attributes_df as tcli
    from gan_control_torch.inference.inference import Inference

    model_dir = write_phase1_dir(tmp_path / "phase1", tiny_model_config(("orientation_loss",)))
    want_path = tmp_path / "jax.pkl"
    monkeypatch.setattr(sys, "argv", [
        "make_attributes_df.py", "--model_dir", str(model_dir), "--batch_size", "2",
        "--number_of_samples", "4", "--save_path", str(want_path), "--no_shard"])
    jcli.main()
    want = pd.read_pickle(want_path)
    common = ["--model_dir", str(model_dir), "--batch_size", "2", "--number_of_samples", "4",
              "--device", "cpu"]
    tcli.main(common + ["--save_path", str(tmp_path / "port.pkl")])
    tcli.main(common + ["--save_path", str(tmp_path / "port.npz")])
    got = pd.read_pickle(tmp_path / "port.pkl")
    assert list(got.columns) == list(want.columns) == ["latents", "latents_w", "orientation"]
    assert len(got) == len(want) == 4
    for col in want.columns:
        for i in range(4):
            g, w = got[col][i], want[col][i]
            assert type(g) is type(w) and np.shape(g) == np.shape(w), col
            assert getattr(g, "dtype", None) == getattr(w, "dtype", None), col
        assert np.isfinite(np.stack(got[col])).all()
    npz = tdf.read_table(tmp_path / "port.npz")
    for col in want.columns:
        np.testing.assert_array_equal(npz[col], np.stack(got[col]))
    inf = Inference(model_dir, device="cpu")
    with torch.no_grad():
        w = inf.model.map_latent(torch.from_numpy(npz["latents"])).numpy()
    _close(npz["latents_w"], w, 1e-6)
    # --align_3d without FAN weights: the bicubic fallback's columns, as the JAX command line's
    monkeypatch.setattr(sys, "argv", [
        "make_attributes_df.py", "--model_dir", str(model_dir), "--batch_size", "2",
        "--number_of_samples", "2", "--save_path", str(tmp_path / "jax_aligned.pkl"), "--no_shard",
        "--align_3d"])
    jcli.main()
    tcli.main(common[:4] + ["--number_of_samples", "2", "--device", "cpu", "--align_3d",
                            "--save_path", str(tmp_path / "aligned.npz")])
    want = pd.read_pickle(tmp_path / "jax_aligned.pkl")
    got = tdf.read_table(tmp_path / "aligned.npz")
    assert list(got) == list(want.columns)
    for col in want.columns:
        assert got[col].shape == np.stack(want[col]).shape and np.isfinite(got[col]).all()
