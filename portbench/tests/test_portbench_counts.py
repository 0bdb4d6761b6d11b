"""The committed counts are what the reference gives on the meta device,
and they agree with the step counts the port's own accounting reported."""

from __future__ import annotations

import json

import pytest

from portbench import harness
from portbench.counts import make

CONFIGS = [c["name"] for c in harness.benchmark()["configs"]]


@pytest.mark.parametrize("config", CONFIGS)
def test_counts_recompute(config):
    got = json.loads(json.dumps(make.counts(config), sort_keys=True))
    assert got == harness.counts(config)


def test_reg_steps_plain_plan():
    """The plain plan counts no recompute: R1 and path length at the FLOPs
    the port's accounting gave them before the memory plan (11.905 and
    10.835 TFLOP) and the plain plan's launches."""
    steps = harness.counts("ffhq512")["train"]["per_step"]
    assert sum(steps["d_reg_step"]["flops"].values()) / 1e12 == pytest.approx(11.905, abs=5e-4)
    assert sum(steps["g_reg_step"]["flops"].values()) / 1e12 == pytest.approx(10.835, abs=5e-4)
    assert steps["d_reg_step"]["kernel_launches"]["fused_bias_act"] == 17
    assert steps["d_reg_step"]["kernel_launches"]["blur_sep"] == 56
    assert steps["g_reg_step"]["kernel_launches"]["fused_bias_act"] == 71


@pytest.mark.parametrize("config", CONFIGS)
def test_launched_counts_hold_the_recompute(config):
    """The roofline's bytes are the launches under the trainer's plan
    (``remat_reg``): each reg step's backward recomputes D's seven ResBlocks
    twice (+28 ``fused_bias_act``, +28 ``blur_sep``) and G's fourteen
    StyledConvs twice (+28 ``fused_bias_act``)."""
    train = harness.counts(config)["train"]
    plain, launched = train["per_step"], train["launched"]
    assert launched["remat_reg"] is True
    extra = {"d_reg_step": {"fused_bias_act": 28, "blur_sep": 28}, "g_reg_step": {"fused_bias_act": 28}}
    for step, more in extra.items():
        want = dict(plain[step]["kernel_launches"])
        for k, v in more.items():
            want[k] += v
        assert launched["per_step"][step]["kernel_launches"] == want
    assert launched["cadence"]["kernel_bytes"] > train["cadence"]["kernel_bytes"]


def test_serving_counts_are_per_row():
    s = harness.counts("ffhq512")["serve"]
    per = s["per_bucket"]
    for b in ("4", "16"):
        want = {k: s["per_request_flops"][k] + int(b) * s["per_image_flops"][k]
                for k in s["per_image_flops"]}
        for k, v in want.items():
            assert per[b]["flops"].get(k, 0) == pytest.approx(v, rel=1e-9)
