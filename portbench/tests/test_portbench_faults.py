"""A run with its timed path broken underneath, or with the control in the
program's place, comes out not correct under the cells' limits: the
harness's look for a card skipped, the rest of a run driven at 32 px on the
CPU."""

from __future__ import annotations

import pytest

from portbench.tests.tiny import tiny_serve, tiny_train


def not_correct(res) -> bool:
    return not all(c["ok"] for c in res["checks"])


AFHQ_NETS = ("orientation_loss", "classification_loss", "dog_id_loss")


# each fault with the cell whose limits catch it on the card (PERF.md); the
# battery's faults run with nets whose gradient outweighs rounding at 32 px
@pytest.mark.parametrize("cell,fault,losses", [
    ("ffhq512-train", "frozen_state", ()),
    ("ffhq512-train", "half_batch", ()),
    ("ffhq512-train", "half_batch_path", ()),
    ("ffhq512-train", "sign_flip", ()),
    ("ffhq512-train", "drop_battery", ("embedding_loss", "recon_3d_loss")),
    ("ffhq512-train", "half_batch_battery", ("embedding_loss", "recon_3d_loss")),
    ("afhq512-train-ada", "frozen_state", ()),
    ("afhq512-train-ada", "half_batch", ()),
    ("afhq512-train-ada", "sign_flip", ()),
    ("afhq512-train-ada", "half_batch_battery", AFHQ_NETS),
])
def test_training_fault_is_caught(cell, fault, losses):
    assert not_correct(tiny_train(cell, losses=losses, f32=True, fault=fault))


@pytest.mark.parametrize("cell,losses", [("ffhq512-train", ("embedding_loss", "recon_3d_loss")),
                                         ("afhq512-train-ada", AFHQ_NETS)])
def test_training_control_is_caught(cell, losses):
    # the battery is where the control departs most at this size
    assert not_correct(tiny_train(cell, losses=losses, control=True))


def test_serving_fault_is_caught():
    assert not_correct(tiny_serve(f32=True, fault="altered_answer"))


def test_serving_control_is_caught():
    assert not_correct(tiny_serve(control=True))
