"""The plain reference held to the port at 32 px on the CPU: with the
program in f32 (TF32 does not arise on the CPU), the cells' correctness
numbers read rounding alone."""

from __future__ import annotations

import torch

from portbench.reference import build
from portbench.tests.tiny import SEED, tiny_config, tiny_serve, tiny_train


def test_frozen_generator_is_the_ports():
    from gan_control_torch.models.factory import build_generator, build_group_spec

    config = tiny_config("ffhq512", f32=True)
    port = build_generator(config, build_group_spec(config), device="cpu", seed=3)
    ref = build.generator(config, build.group_spec(config), "cpu", torch.float32, None)
    ref.load_state_dict(port.state_dict())
    z = torch.randn(4, 512, generator=torch.Generator().manual_seed(SEED))
    noise = [torch.randn(s, generator=torch.Generator().manual_seed(i))
             for i, s in enumerate(port.noise_shapes(4))]
    with torch.no_grad():
        a, _ = port([z], noise=noise)
        b, _ = ref([z], noise=noise)
    assert torch.allclose(a, b, rtol=0, atol=1e-5)


def test_train_reference_follows_the_program():
    res = tiny_train(losses=("expression_loss",), f32=True)
    n = res["numbers"]
    assert n["adv_loss_gap"] < 1e-5 and n["loss_gap"] < 1e-4 and n["battery_gap"] < 1e-4, n
    assert max(n["grad_gaps"]) < 1e-3 and n["change_gap"] < 1e-2, n
    assert max(n["d_grad_vec_gap"], n["r1_grad_vec_gap"], n["g_grad_vec_gap"],
               n["path_grad_vec_gap"]) < 1e-3, n
    assert n["r1_gap"] < 1e-4 and n["path_gap"] < 1e-4 and n["battery0_gap"] < 1e-4, n
    assert all(c["ok"] for c in res["checks"]), res["checks"]


def test_serve_reference_follows_the_program():
    res = tiny_serve(f32=True)
    n = res["numbers"]
    assert n["w_gap"] < 1e-5 and n["img_worst_mae"] < 0.1, n
    assert res["checked"]["requests"] > 0
    assert all(c["ok"] for c in res["checks"]), res["checks"]


def test_the_programs_own_draws_do_not_matter(monkeypatch):
    """The checked iterations run on the benchmark's draws, handed to both
    sides: a program that draws its z and its injection noise otherwise
    still reads rounding alone."""
    from gan_control_torch.models import blocks
    from gan_control_torch.trainers import generator_trainer as gt

    sample_z = gt.GeneratorTrainer._sample_z
    monkeypatch.setattr(gt.GeneratorTrainer, "_sample_z",
                        lambda self, batch: tuple(-z for z in sample_z(self, batch)))
    monkeypatch.setattr(blocks, "_draw_noise", lambda x, generator=None: torch.zeros_like(x[..., :1]))
    n = tiny_train(f32=True)["numbers"]
    assert n["adv_loss_gap"] < 1e-5 and n["g_grad_vec_gap"] < 1e-3 and n["change_gap"] < 1e-2, n
