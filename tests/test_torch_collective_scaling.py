"""``gan_control_torch/tools/collective_scaling.py`` against the JAX
package's ``tools/ici_scaling.py``: the FFHQ-512 parameter bytes and, at
the JAX tool's constants, the projection's rows. Part A's counts on two
gloo ranks ride the spawn of ``tests/test_torch_distributed_train.py``.
"""

import json
import sys
from pathlib import Path

import pytest

from gan_control_torch.tools import collective_scaling as cs
from gan_control_torch.utils import collectives

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tools import ici_scaling as jt  # noqa: E402


@pytest.fixture(scope="module")
def jax_param_bytes():
    return jt.flagship_param_bytes()


def test_flagship_param_bytes_equal_the_jax_tools(jax_param_bytes):
    assert cs.flagship_param_bytes() == jax_param_bytes
    assert jax_param_bytes == {"g": 124812188, "d": 115931396}


@pytest.mark.parametrize("ratio", [1.0, 1.377, 2.2])
def test_projection_at_the_jax_constants_reproduces_its_rows(jax_param_bytes, ratio):
    """The JAX tool's TPU figures passed as arguments (one ring rate at
    every size): every row, rounded as the JAX tool rounds, to 1e-9."""
    got = cs.project_scaling(jax_param_bytes, jt.SINGLE_CHIP_MS_PER_ITER, jt.ICI_RING_BW, traffic_ratio=ratio)
    want = jt.project_scaling(jax_param_bytes, ratio)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k] == pytest.approx(w[k], rel=1e-9, abs=1e-9), (g["chips"], k)


def test_ring_allreduce_is_the_jax_formula():
    for n in (1, 2, 4, 8, 16):
        assert cs.ring_allreduce_s(3e8, n, jt.ICI_RING_BW) == pytest.approx(jt.ring_allreduce_s(3e8, n), rel=1e-12)


def test_projection_beyond_a_node_takes_the_inter_node_rate(jax_param_bytes):
    """Up to 8 cards the ring runs at NVLink's one-way rate, at 16 at the
    InfiniBand port's; no TPU figure enters."""
    rows = {r["chips"]: r for r in cs.project_scaling(jax_param_bytes, 400.0, cs.NVLINK_RING_BW,
                                                      cs.INTER_NODE_RING_BW)}
    ar = jax_param_bytes["d"] * (1 + 1 / 16) + jax_param_bytes["g"] * (1 + 1 / 4)
    assert rows[1]["allreduce_ms"] == 0 and rows[1]["weak_efficiency"] == 1.0
    assert rows[8]["allreduce_ms"] == round(2 * 7 / 8 * ar / 450e9 * 1e3, 2)
    assert rows[16]["allreduce_ms"] == round(2 * 15 / 16 * ar / 50e9 * 1e3, 2)
    assert cs.NVLINK_RING_BW != jt.ICI_RING_BW and cs.INTER_NODE_RING_BW != jt.ICI_RING_BW


def _rank0(grad_bytes: int):
    """A rank's record of the four steps: one gradient all-reduce each of
    ``grad_bytes``, one metrics all-reduce and one gather."""
    pb = {"g": 400, "d": 200}

    def calls(kind):
        n = pb[kind[0]] if grad_bytes is None else grad_bytes
        return [collectives.Call("all_gather", "gather models/blocks.py:1", (2, 3), "float32", 24),
                collectives.Call("all_reduce", "gradients", (n // 4,), "float32", n),
                collectives.Call("all_reduce", "metrics", (2,), "float32", 8)]

    return {"param_bytes": pb, "steps": {k: calls(k) for k in cs.STEP_KINDS}}


def test_a_step_without_gradient_bytes_on_two_ranks_raises():
    with pytest.raises(RuntimeError, match="no gradient bytes"):
        cs.summarise(2, _rank0(0))
    assert cs.summarise(1, _rank0(0))["steps"]["d_step"]["gradient_ratio"] == 0


def test_main_writes_its_record(monkeypatch, tmp_path):
    """The command line on Part A's records (two ranks' worth, not spawned
    here): the JSON names every input with its source, says it projects,
    and records no card on the CPU."""
    monkeypatch.setattr(cs, "run_ranks", lambda world: [_rank0(None)] * world)
    out = tmp_path / "cs.json"
    cs.main(["--iteration_ms", "436.5", "--worlds", "2", "--out", str(out)])
    rec = json.loads(out.read_text())
    assert rec["card"] is None and "projection" in rec["note"]
    assert [r["chips"] for r in rec["projection"]] == [1, 2, 4, 8, 16]
    assert rec["traffic_ratio"] == pytest.approx(208 / 200)
    for key in ("iteration_ms", "nvlink_ring_bw", "inter_node_ring_bw", "traffic_ratio"):
        assert rec["inputs"][key]["source"], key
    assert rec["inputs"]["iteration_ms"]["value"] == 436.5
    (world2,) = rec["collectives"]
    assert world2["steps"]["g_step"]["gradient_ratio"] == 1.0
    with pytest.raises(SystemExit):
        cs.main(["--out", str(out)])
