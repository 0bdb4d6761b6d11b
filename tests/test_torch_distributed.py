"""The port's data parallelism on the CPU, the host pieces: the process
group (``utils/multihost.py``), the collectives (``utils/collectives.py``),
row sharding (``utils/mesh.py``), and the sharded FID chunk, attribute
sweep, ``calc_inception`` and controller step.

Two ranks over gloo run ``tests/_torch_dist_worker.py host`` once for the
whole file (started as torchrun starts ranks, one intra-op thread each);
this process runs the same functions in one process at the global batch
meanwhile, and each test holds the ranks to that. Tolerances: f32
throughout; the ranks run the same arithmetic on half the rows, so values
agree to rounding (1e-6 relative, gradients 1e-5 of each tensor's largest
entry); the predictors' columns and the Inception statistics, nets at
batch 2 against batch 4, to 1e-4 of their largest entry.
"""

import datetime
import socket
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_dist_worker as wk
from gan_control_torch.utils import collectives, mesh, multihost

REL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _write_run_dir(root: Path) -> Path:
    """A tiny phase-1 run directory whose sweep runs Hopenet and ESR-9
    (random init): a GeneratorTrainer's ``save_nets(0)``."""
    from gan_control_torch.trainers.generator_trainer import GeneratorTrainer

    config = wk.trainer_config(root)
    for name, block in config["training_config"].items():
        if name.endswith("_loss") and isinstance(block, dict) and "enabled" in block:
            block["enabled"] = name in ("orientation_loss", "expression_loss")
    tr = GeneratorTrainer(config=config, device="cpu")
    tr.save_nets(0, block=True)
    tr.close()
    return tr.save_dir


def _write_images(root: Path, n: int = 8) -> Path:
    from PIL import Image

    root.mkdir()
    rng = np.random.default_rng(0)
    for i in range(n):
        Image.fromarray((rng.random((24, 24, 3)) * 255).astype(np.uint8)).save(root / f"{i:03d}.png")
    return root


def _inputs(root: Path) -> dict:
    from gan_control_torch.data.dataframe import write_table
    from gan_control_torch.evaluation import fid as fid_lib

    rng = np.random.default_rng(1)
    run_dir = _write_run_dir(root / "runs")
    stats_path = root / "stats.pkl"
    fid_lib.save_stats(stats_path, *fid_lib.compute_stats(rng.standard_normal((40, wk.FEATURES))))
    table = root / "table.npz"
    n = 40
    write_table(table, {"latents_w": rng.standard_normal((n, 512)).astype(np.float32),
                        "orientation": rng.normal(size=(n, 3)).astype(np.float32)})
    ctrl_config = {
        "save_name": "ctrl", "results_dir": str(root / "controllers"),
        "model_config": {"loss": "orientation_loss", "in_dim": 3, "n_mlp": 2, "mid_dim": 32},
        "training_config": {"generator_dir": str(run_dir), "sampled_df_path": str(table),
                            "batch": wk.BATCH, "losses": ["latent_rec", "attribute_rec"],
                            "attribute_rec_w": 0.5, "debug": True},
    }
    x = torch.from_numpy(rng.standard_normal((wk.BATCH, 4, 4, 6)).astype(np.float32))
    return {
        "x": x, "w": torch.from_numpy(rng.uniform(0.5, 1.5, 6).astype(np.float32)),
        "k": torch.from_numpy(rng.standard_normal((wk.BATCH, 4, 4, 7)).astype(np.float32)),
        "g_sd": wk.snapshot(wk.tiny_models()[0]), "stats_path": stats_path, "run_dir": run_dir,
        "image_dir": _write_images(root / "images"), "ctrl_config": ctrl_config,
        "controls": rng.normal(size=(wk.BATCH, 3)).astype(np.float32),
        "latents_w": rng.standard_normal((wk.BATCH, 512)).astype(np.float32),
    }


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(the two ranks' results, this process's references, the directory)."""
    from gan_control_torch import calc_inception, make_attributes_df

    root = tmp_path_factory.mktemp("dist_host")
    inputs = _inputs(root)
    torch.save(inputs, root / "inputs.pt")
    procs = wk.start_ranks("host", root)
    try:
        ref = {"r1": wk.coupled_r1(inputs["x"], inputs["w"], inputs["k"]),
               "mean": wk.coupled_mean(inputs["x"], inputs["w"]),
               "fid": wk.fid_chunks(inputs), "controller": wk.controller_step(inputs)}
        make_attributes_df.main(["--model_dir", str(inputs["run_dir"]), "--batch_size", "4",
                                 "--number_of_samples", "8", "--device", "cpu",
                                 "--save_path", str(root / "one.npz")])
        calc_inception.main(["--path", str(inputs["image_dir"]), "--size", "16", "--batch", "4",
                             "--n_samples", "8", "--save_path", str(root / "stats_one.pkl"),
                             "--device", "cpu"])
    finally:
        ranks = wk.finish_ranks(procs, root)
    return ranks, ref, root


def _close(got, want, rel, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale, err_msg=name)


def test_initialize_without_a_run_is_one_process(monkeypatch):
    for var in ("MASTER_ADDR", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.initialize() == (0, 1)
    assert (multihost.process_index(), multihost.process_count()) == (0, 1)
    assert not torch.distributed.is_initialized()


def test_initialize_with_a_bad_address_raises():
    """An explicit run that cannot reach its rendezvous raises rather than
    training alone (a localhost port nobody listens on)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with pytest.raises(RuntimeError):
        multihost.initialize(device="cpu", init_method=f"tcp://127.0.0.1:{port}", rank=1,
                             world_size=2, timeout=datetime.timedelta(seconds=1))
    assert not torch.distributed.is_initialized()


def test_collectives_are_the_identity_in_one_process():
    x = torch.randn(4, 3, requires_grad=True)
    p = torch.nn.Parameter(torch.randn(3))
    p.grad = torch.ones(3)
    with collectives.sharded_batch():
        assert not collectives.sharded()
        assert collectives.gather_batch(x) is x and collectives.own_rows(x) is x
        assert collectives.global_batch(4) == (4, slice(None))
    assert collectives.all_gather(x) is x and collectives.any_rank(True)
    m = {"a": torch.tensor(2.0)}
    assert collectives.mean_metrics(m) is m and collectives.broadcast_object(5) == 5
    collectives.mean_grads_([p])
    assert torch.equal(p.grad, torch.ones(3))
    assert mesh.data_batch_sharding(8) is None


def test_ranks_join_over_gloo(run):
    ranks, _, _ = run
    for r, res in enumerate(ranks):
        assert (res["rank"], res["size"], res["index"], res["count"]) == (r, 2, r, 2)
        assert res["backend"] == "gloo"


def test_row_sharding_and_host_agreements(run):
    ranks, _, _ = run
    assert [res["rows"] for res in ranks] == [slice(0, 4), slice(4, 8)]
    assert [res["rows_of_16"] for res in ranks] == [slice(0, 8), slice(8, 16)]
    for res in ranks:
        assert res["indivisible"] is None
        assert res["broadcast"] == "from rank 0"
        assert res["any_one"] and not res["any_none"]
        assert res["metrics"] == {"a": 0.5, "b": 2.0}


def test_gather_second_derivative_matches_one_process(run):
    """R1's shape through the minibatch stddev, whose groups span both
    ranks: the statistic, the input gradient (the gather's backward) and
    the parameter gradient of the penalty on it (its double backward)."""
    ranks, ref, _ = run
    y, gx, penalty, w_grad = ref["r1"]
    for r, res in enumerate(ranks):
        ry, rgx, rpen, rw = res["r1"]
        _close(ry, y[4 * r : 4 * r + 4], 1e-6, "statistic")
        _close(rgx, gx[4 * r : 4 * r + 4], REL, "input gradient")
        np.testing.assert_allclose(rpen, penalty, rtol=1e-6)
        _close(rw, w_grad, REL, "parameter gradient")
    assert torch.equal(ranks[0]["r1"][3], ranks[1]["r1"][3])


def test_gather_first_derivative_matches_one_process(run):
    ranks, ref, _ = run
    loss, w_grad = ref["mean"]
    for res in ranks:
        np.testing.assert_allclose(res["mean"][0], loss, rtol=1e-6)
        _close(res["mean"][1], w_grad, REL)


def test_sharded_fid_matches_one_process(run):
    """Each rank synthesises half of each chunk from the chunk's draws; the
    gathered features and the FID are the one-process ones, on every rank."""
    ranks, ref, _ = run
    for res in ranks:
        _close(res["fid"]["features"], ref["fid"]["features"], 1e-6, "features")
        np.testing.assert_allclose(res["fid"]["fid"], ref["fid"]["fid"], rtol=1e-6)
    assert ranks[0]["fid"]["fid"] == ranks[1]["fid"]["fid"]


def test_sharded_sweep_writes_the_unsharded_table(run):
    """make_attributes_df over two ranks (batch 4: two rows each) writes one
    table equal to the one-process sweep's; with --no_shard every rank runs
    whole batches and rank 0 writes the same table."""
    from gan_control_torch.data.dataframe import read_table

    _, _, root = run
    one = read_table(root / "one.npz")
    for name in ("sharded.npz", "whole.npz"):
        got = read_table(root / name)
        assert set(got) == set(one) and {"orientation", "expression_q"} <= set(one)
        for col, want in one.items():
            assert got[col].shape == want.shape, (name, col)
            if col == "expression_q":
                np.testing.assert_array_equal(got[col], want)
            else:
                _close(got[col], want, 1e-5 if col.startswith("latents") else 1e-4, f"{name} {col}")


def test_sharded_calc_inception_writes_the_one_process_statistics(run):
    from gan_control_torch.evaluation import fid as fid_lib

    _, _, root = run
    mu, cov = fid_lib.load_stats(root / "stats_sharded.pkl")
    want_mu, want_cov = fid_lib.load_stats(root / "stats_one.pkl")
    _close(mu, want_mu, 1e-4, "mean")
    _close(cov, want_cov, 1e-4, "cov")


def test_controller_step_matches_one_process(run):
    """latent_rec and attribute_rec (noise drawn at the global batch): the
    head's gradients, averaged over ranks, and the metrics are the
    one-process step's; an indivisible training batch raises."""
    ranks, ref, _ = run
    want = ref["controller"]
    for res in ranks:
        got = res["controller"]
        assert set(got["grads"]) == set(want["grads"])
        for n, g in want["grads"].items():
            _close(got["grads"][n], g, REL, n)
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-6, err_msg=k)
        assert "not divisible by the 2 ranks" in res["indivisible_controller"]
    for n in want["head"]:
        assert torch.equal(ranks[0]["controller"]["head"][n], ranks[1]["controller"]["head"][n])
