"""The evaluation cadence of the port's ``GeneratorTrainer`` against the JAX
trainer, and a size-32 run that evaluates.

``_eval_due`` is held to the JAX method (called unbound on a namespace that
holds only ``tc``) over iterations 0..1000, debug on and off. Then a
size-32 trainer on the CPU (FFHQ's losses and evaluations, cut to three
latent groups of a 32-d latent and a batch of 8, with the ArcFace, Hopenet
and ESR-9 losses at random init, a ``__random__`` Inception against a
statistics pickle written here) runs iterations 1 and 2 (past the R1 and
path-length steps of iteration 0) with every evaluation due at iteration 2:
the metrics record, ``best_fid.ckpt``, the plots, the annotated matrices
and the bucket image, and no "not ported" warning. The Fréchet distance is
recorded, not computed (a 2048² ``sqrtm`` takes seconds, and
``tests/test_torch_fid.py`` holds it to JAX): the test checks that it gets
the statistics of the FID's features and of the pickle, and that its value
is the logged FID.
"""

import json
import logging
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gan_control_tpu.trainers.generator_trainer import GeneratorTrainer as JGeneratorTrainer

from gan_control_torch.data.datasets import synthetic_data_loader
from gan_control_torch.evaluation import fid as fid_lib
from gan_control_torch.evaluation.inception import load_inception
from gan_control_torch.losses.registry import build_attr_losses
from gan_control_torch.trainers.generator_trainer import GeneratorTrainer

CONFIGS = Path(__file__).resolve().parent.parent / "gan_control_tpu" / "configs"
FFHQ = json.loads((CONFIGS / "ffhq.json").read_text())


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch thread for this file: the suite runs six workers on the
    box's cores, and a pool of one thread per core in each of them thrashes
    (this file's tests ran ~20x slower than alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("debug", [False, True])
@pytest.mark.parametrize("min_int,interval", [(100, 10000), (100, 30000), (2, 2), (10, 4), (7, 21)])
def test_eval_due_equals_the_jax_trainer(debug, min_int, interval):
    tc = {"debug": debug, "min_evaluate_interval": min_int}
    j_ns, t_ns = SimpleNamespace(tc=tc), SimpleNamespace(tc=tc)
    got = [GeneratorTrainer._eval_due(t_ns, i, interval) for i in range(1001)]
    want = [JGeneratorTrainer._eval_due(j_ns, i, interval) for i in range(1001)]
    assert got == want
    assert not got[0]


def _small_config(tmp_path: Path) -> dict:
    config = json.loads(json.dumps(FFHQ))
    mc, tc, ec = config["model_config"], config["training_config"], config["evaluation_config"]
    mc.update(size=32, max_channels=16, n_mlp=2, latent_size=32, mixed_precision=False,
              remat_predictors=False)
    tc.update(batch=8, mini_batch=8, predictor_dtype="float32", min_evaluate_interval=2,
              save_images_interval=2, log_every=1, start_iter=1)
    tc["sub_groups_dict"] = {
        "id": {"count_in_mini_bach": [2, 6], "place_in_mini_batch": [0, 4], "place_in_latent": [0, 16]},
        "expression": {"count_in_mini_bach": [2, 6], "place_in_mini_batch": [4, 6],
                       "place_in_latent": [16, 24]},
        "orientation": {"count_in_mini_bach": [2, 6], "place_in_mini_batch": [6, 8],
                        "place_in_latent": [24, 32]},
    }
    for name in ("age_loss", "hair_loss", "recon_3d_loss"):
        tc[name]["enabled"] = False
    stats = tmp_path / "stats.pkl"
    ec["fid"].update(inception_weights="__random__", inception_stat_path=str(stats), fid_interval=2,
                     num_of_samples=12, batch_size=4)
    ec["separability"].update(separability_interval=2, num_of_samples=8)
    ec["orientation_hist"].update(orientation_hist_interval=2, num_of_samples=8)
    ec["expression_bar"].update(expression_bar_interval=2, num_of_samples=8)
    config["tensorboard_config"]["enabled"] = False
    config["monitor_config"]["enabled"] = True
    config["results_dir"] = str(tmp_path / "results")
    return config


def test_trainer_evaluates_on_the_jax_cadence(tmp_path, monkeypatch):
    config = _small_config(tmp_path)
    rng = np.random.default_rng(0)
    real = fid_lib.extract_features(fid_lib.make_feature_fn(load_inception("__random__")),
                                    (rng.random((6, 32, 32, 3)).astype(np.float32) for _ in range(2)), 12)
    fid_lib.save_stats(config["evaluation_config"]["fid"]["inception_stat_path"],
                       *fid_lib.compute_stats(real))
    specs, predictors = build_attr_losses(config["training_config"], device="cpu", seed=0)
    assert [s.name for s in specs] == ["embedding_loss", "orientation_loss", "expression_loss"]
    distances = []
    monkeypatch.setattr(fid_lib, "frechet_distance", lambda *a: distances.append(a) or 123.25)
    records = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = records.append
    log = logging.getLogger("gan_control_torch.trainers.generator_trainer")
    log.addHandler(handler)
    try:
        tr = GeneratorTrainer(config=config, device="cpu", attr_losses=specs, predictors=predictors,
                              data_loader=synthetic_data_loader(8, 32, seed=3))
        tr.train(3)
        tr.close()
    finally:
        log.removeHandler(handler)
    warnings = [r.getMessage() for r in records]
    assert not [w for w in warnings if "not ported" in w], warnings
    assert any("__random__" in w for w in warnings)

    save = tr.save_dir
    recs = [json.loads(ln) for ln in (save / "metrics.jsonl").read_text().splitlines()]
    assert [r["iter"] for r in recs] == [1, 2]
    last = recs[-1]
    for key in ("fid", "best_fid", "separability/embedding_loss/l0_same_mean",
                "separability/embedding_loss/l0_2ndbest_mean", "separability/embedding_loss/l0_margin",
                "orientation/yaw_std", "g_embedding_loss", "iter_time_mean"):
        assert key in last and np.isfinite(last[key]), key
    assert last["fid"] == last["best_fid"] == tr.tracker.best_fid == 123.25
    assert "fid" not in recs[0] and tr.fid_features.shape == (12, 2048)
    assert len(distances) == 1
    want = (*fid_lib.compute_stats(tr.fid_features),
            *fid_lib.load_stats(config["evaluation_config"]["fid"]["inception_stat_path"]))
    for got, w in zip(distances[0], want):
        np.testing.assert_array_equal(got, w)
    header = (save / "monitor.csv").read_text().splitlines()[0].split(",")
    assert "fid" in header and "orientation/yaw_std" in header
    ckpts = sorted(p.name for p in (save / "checkpoint").iterdir())
    assert ckpts == ["000003.ckpt", "best_fid.ckpt"]
    for path in ("graphs/orientation_000002.jpg", "graphs/expression_000002.jpg",
                 "buckets/embedding_loss/000002.jpg",
                 "images/orientation_matrix/000002.jpg", "images/expression_matrix/000002.jpg",
                 "images/attribute_matrix/000002.jpg", "images/id/000002.jpg"):
        assert (save / path).is_file(), path
    assert not (save / "images" / "age_matrix").exists()

    # best_fid.ckpt (saved after iteration 2, the last) resumes in a fresh
    # trainer at the configured start_iter, with the EMA G that was scored
    config["ckpt_config"] = {"enabled": True, "ckpt": str(save / "checkpoint" / "best_fid.ckpt")}
    again = GeneratorTrainer(config=config, device="cpu", init_dirs=False,
                             data_loader=synthetic_data_loader(8, 32, seed=3))
    assert again.start_iter == 1 and again.state.step == 2
    for k, v in again.state.g_ema.state_dict().items():
        assert torch.equal(v, tr.state.g_ema.state_dict()[k]), k
