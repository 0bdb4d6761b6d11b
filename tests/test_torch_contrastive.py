"""Parity of the port's contrastive criterion and its helpers with the JAX
package: the pairwise distances (values and gradients), the static masks,
``ContrastiveConfig.from_json``, ``contrastive_loss``, the latent-group
split of a mini-batch, the pretrained-weight dispatch and the battery's
precision and dtype switches.

Inputs are seeded numpy arrays handed to both sides, f32 (JAX at "highest"
precision). Values and gradients are held to 1e-5 relative: a handful of
sums and absolute values in another order.
"""

import json
from pathlib import Path

import flax.serialization
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gan_control_tpu.latent import groups as jgroups
from gan_control_tpu.losses import contrastive as jc
from gan_control_tpu.models.factory import build_group_spec as j_build_group_spec
from gan_control_tpu.utils.precision import predictor_precision as j_predictor_precision

from gan_control_torch.latent import groups as tgroups
from gan_control_torch.losses import contrastive as tc
from gan_control_torch.models.factory import build_group_spec as t_build_group_spec
from gan_control_torch.utils import precision
from gan_control_torch.utils.weights import load_pretrained

REL = 1e-5
CONFIGS = Path(__file__).resolve().parent.parent / "gan_control_tpu" / "configs"
FFHQ = json.loads((CONFIGS / "ffhq.json").read_text())
DISTANCES = ("pairwise_sq_l2", "pairwise_l1", "pairwise_mse_gram", "pairwise_hair_color")


def _randn(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _hair_features(n, seed, hw=16):
    """NHWC [n, hw, hw, 4]: a masked image and its 0/1 mask, with image 0
    bald (no hair pixel) and image 1 below the 1 % validity threshold."""
    rng = np.random.default_rng(seed)
    mask = (rng.uniform(size=(n, hw, hw, 1)) < 0.4).astype(np.float32)
    mask[0] = 0
    mask[1] = 0
    mask[1, 0, 0] = 1  # 1 of 256 pixels: above 0.5 but not above 1 %
    img = rng.uniform(-1, 1, size=(n, hw, hw, 3)).astype(np.float32)
    return np.concatenate([img * mask, mask], axis=-1)


def _features(name, n, seed):
    if name == "pairwise_hair_color":
        return _hair_features(n, seed)
    return _randn((n, 3, 5) if name != "pairwise_sq_l2" else (n, 16), seed)


def _close(got, want, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=REL,
                               atol=REL * max(float(np.abs(want).max()), 1e-12), err_msg=what)


@pytest.mark.parametrize("name", DISTANCES)
def test_pairwise_distance_and_gradient_match_jax(name):
    """[N, N] and the cross-set [N, M] forms, and the gradient of a seeded
    projection with respect to both inputs. For the hair distance the mask
    channel takes no gradient (the validity and the mask sum are detached)."""
    jfn, tfn = getattr(jc, name), getattr(tc, name)
    a, b = _features(name, 6, 1), _features(name, 4, 2)
    proj = _randn((6, 6), 3)
    for args in ((a,), (a, b)):
        want = jfn(*map(jnp.asarray, args))
        ta = [torch.from_numpy(x).requires_grad_(True) for x in args]
        got = tfn(*ta)
        _close(got.detach().numpy(), want, name)
        p = proj[: want.shape[0], : want.shape[1]]
        wgrads = jax.grad(lambda *xs: jnp.sum(jfn(*xs) * p), argnums=tuple(range(len(args))))(
            *map(jnp.asarray, args))
        tgrads = torch.autograd.grad((got * torch.from_numpy(p)).sum(), ta)
        for g, w in zip(tgrads, wgrads):
            _close(g.numpy(), w, f"{name} gradient")
    if name == "pairwise_hair_color":
        d = tfn(torch.from_numpy(a)).numpy()
        assert np.all(d[:2] == 0) and np.all(d[:, :2] == 0) and np.any(d[2:, 2:] > 0)
        (g,) = torch.autograd.grad(tfn(ta[0]).sum(), ta[0])
        assert not torch.any(g[..., 3])


@pytest.mark.parametrize("n_same,n_not", [(2, 14), (4, 12), (6, 2), (8, 8)])
def test_static_masks_match_jax(n_same, n_not):
    n = n_same + n_not
    np.testing.assert_array_equal(tc.strict_lower_mask(n), jc.strict_lower_mask(n))
    np.testing.assert_array_equal(tc.same_pair_mask(n_same // 2, n), jc.same_pair_mask(n_same // 2, n))
    np.testing.assert_array_equal(tc.not_same_pair_mask(n_same // 2, n_not // 2, n),
                                  jc.not_same_pair_mask(n_same // 2, n_not // 2, n))


def _loss_blocks():
    """Every contrastive loss block of the shipped configs, with the recon
    sub-blocks (enabled or not)."""
    out = []
    for path in sorted(CONFIGS.glob("*.json")):
        tcfg = json.loads(path.read_text()).get("training_config", {})
        for name, block in tcfg.items():
            if isinstance(block, dict) and "focus_on_list" in block:
                out.append((f"{path.stem}:{name}", block))
                for sub, sub_block in block.items():
                    if isinstance(sub_block, dict) and "focus_on_list" in sub_block:
                        out.append((f"{path.stem}:{name}.{sub}", sub_block))
    return out


def test_contrastive_config_from_json_matches_jax():
    blocks = _loss_blocks()
    assert len(blocks) >= 10 and any(b.get("intermediate_criterion_as_last_layer") for _, b in blocks)
    for where, block in blocks:
        got, want = tc.ContrastiveConfig.from_json(block), jc.ContrastiveConfig.from_json(block)
        assert got.__dict__ == want.__dict__, where
        assert got.weights == want.weights, where


CASES = {
    # FFHQ's embedding block: four intermediate layers at weight 0, the
    # focus of the perceptual layers on the other groups' pairs
    "embedding": (FFHQ["training_config"]["embedding_loss"], "pairwise_sq_l2", (4, 12)),
    # weighted intermediate layers, pulled together on the not-same pairs
    "not_same": (dict(intermediate_layers_weights=[0.5, 0.3], last_layer_weight=2.0,
                      lower_thres=[0.1, 0.2], upper_thres=[0.8, 0.9], last_lower_thres=1.0,
                      last_upper_thres=20.0, focus_on_list=["not_same_as_last_layer",
                                                            "same_as_last_layer", "same_as_last_layer"]),
                 "pairwise_sq_l2", (4, 12)),
    # the style criterion on every layer, the gram distance
    "as_last": (dict(intermediate_layers_weights=[1.0], last_layer_weight=0.5, lower_thres=[0.2],
                     upper_thres=[0.9], last_lower_thres=0.1, last_upper_thres=1.5,
                     focus_on_list=["not_same_as_last_layer", "same_as_last_layer"],
                     intermediate_criterion_as_last_layer=True), "pairwise_mse_gram", (2, 6)),
    # the hair criterion with its validity mask; some pairs fall on the hinge
    "hair": (FFHQ["training_config"]["hair_loss"], "pairwise_hair_color", (6, 10)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_contrastive_loss_and_gradient_match_jax(case):
    block, dist, (n_same, n_not) = CASES[case]
    j_cfg, t_cfg = jc.ContrastiveConfig.from_json(block), tc.ContrastiveConfig.from_json(block)
    n_layers = len(j_cfg.weights)
    same, not_same = [], []
    for li in range(n_layers):
        is_last = li == n_layers - 1
        if dist == "pairwise_hair_color":
            feats = _hair_features(n_same + n_not, 10 + li)
        elif is_last or j_cfg.intermediate_as_last:
            feats = _features(dist, n_same + n_not, 10 + li) * 0.3
        else:
            feats = _randn((n_same + n_not, 4, 4, 3), 10 + li, 0.2)
        same.append(feats[:n_same])
        not_same.append(feats[n_same:])
    jfn, tfn = getattr(jc, dist), getattr(tc, dist)

    def j_loss(s, ns):
        return jc.contrastive_loss(j_cfg, s, ns, jfn)

    want, (wgs, wgn) = jax.value_and_grad(j_loss, argnums=(0, 1))(
        [jnp.asarray(f) for f in same], [jnp.asarray(f) for f in not_same])
    ts = [torch.from_numpy(f).requires_grad_(True) for f in same]
    tn = [torch.from_numpy(f).requires_grad_(True) for f in not_same]
    got = tc.contrastive_loss(t_cfg, ts, tn, tfn)
    assert float(want) > 0
    np.testing.assert_allclose(got.item(), float(want), rtol=REL)
    grads = torch.autograd.grad(got, ts + tn, allow_unused=True)
    for g, w in zip(grads, list(wgs) + list(wgn)):
        if g is None:
            assert not np.any(np.asarray(w))
        else:
            _close(g.numpy(), w, f"{case} gradient")


def test_contrastive_loss_rejects_a_layer_count_mismatch():
    cfg = tc.ContrastiveConfig.from_json(FFHQ["training_config"]["age_loss"])
    f = torch.zeros(4, 3)
    with pytest.raises(ValueError):
        tc.contrastive_loss(cfg, [f, f], [f, f], tc.pairwise_l1)


def test_same_not_same_split_and_group_latent_match_jax():
    """The FFHQ arrangement (7 groups of 2-4 slots in a mini-batch of 16):
    each group's rows and the rest, in order; each group's sub-latent of w
    and w+."""
    j_spec, t_spec = j_build_group_spec(FFHQ), t_build_group_spec(FFHQ)
    feats = _randn((16, 3, 2), 0)
    w, wplus = _randn((16, 512), 1), _randn((16, 4, 512), 2)
    names = [g.name for g in t_spec.groups]
    assert names == [g.name for g in j_spec.groups] and len(names) == 7
    for name in names:
        got = tgroups.same_not_same_split(t_spec, torch.from_numpy(feats), name)
        want = jgroups.same_not_same_split(j_spec, jnp.asarray(feats), name)
        for g, wt in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(wt))
        assert got[0].shape[0] + got[1].shape[0] == 16
        for lat in (w, wplus):
            np.testing.assert_array_equal(
                tgroups.extract_group_latent(t_spec, torch.from_numpy(lat), name).numpy(),
                np.asarray(jgroups.extract_group_latent(j_spec, jnp.asarray(lat), name)))


def test_load_pretrained_dispatch(tmp_path):
    """Missing or empty path: None. A .msgpack file (as the JAX package's
    converter writes it with flax) goes through the port's own reader and
    then ``from_flax``; any other path through ``read_torch``."""
    calls = []

    def read_torch(p):
        calls.append(("torch", p))
        return {"read": p}

    def from_flax(tree):
        calls.append(("flax", sorted(tree)))
        return {"tree": tree}

    assert load_pretrained("", read_torch, from_flax) is None
    assert load_pretrained(None, read_torch, from_flax) is None
    assert load_pretrained(str(tmp_path / "absent.pt"), read_torch, from_flax) is None
    assert not calls
    tree = {"params": {"conv": {"weight": _randn((3, 3, 2, 4), 0), "bias": _randn((4,), 1)}}}
    mp = tmp_path / "weights.msgpack"
    mp.write_bytes(flax.serialization.msgpack_serialize(tree))
    got = load_pretrained(str(mp), read_torch, from_flax)["tree"]
    for k in ("weight", "bias"):
        np.testing.assert_array_equal(got["params"]["conv"][k], tree["params"]["conv"][k])
    pt = tmp_path / "weights.pt"
    pt.write_bytes(b"")
    assert load_pretrained(str(pt), read_torch, from_flax) == {"read": str(pt)}
    assert [c[0] for c in calls] == ["flax", "torch"]


def test_predictor_precision_resolution_matches_jax(monkeypatch):
    monkeypatch.delenv(precision.ENV_VAR, raising=False)
    for cfg_value, fallback in ((None, "highest"), (None, "default"), ("tensorfloat32", "default"),
                                ("float32", "default")):
        assert precision.predictor_precision(cfg_value, fallback) == j_predictor_precision(cfg_value, fallback)
    monkeypatch.setenv(precision.ENV_VAR, "highest")
    assert precision.predictor_precision("default", "default") == "highest" == j_predictor_precision(
        "default", "default")
    monkeypatch.setenv(precision.ENV_VAR, "fast")
    with pytest.raises(ValueError):
        precision.predictor_precision()


def test_predictor_precision_ctx_sets_tf32_and_restores(monkeypatch):
    monkeypatch.delenv(precision.ENV_VAR, raising=False)
    flags = lambda: (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)  # noqa: E731
    saved = flags()
    try:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        with precision.predictor_precision_ctx(None, fallback="default"):
            assert flags() == (True, True)
        assert flags() == (False, False)
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        with precision.predictor_precision_ctx("highest"):
            assert flags() == (False, False)
        assert flags() == (True, True)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


class _RecordTF32(torch.autograd.Function):
    """Identity that records the TF32 flags its backward runs under."""

    seen: list = []

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        _RecordTF32.seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
        return grad


@pytest.mark.parametrize("config_value,inside", [("highest", False), ("default", True)])
def test_predictor_precision_covers_the_backward(monkeypatch, config_value, inside):
    """``with_predictor_precision``: the predictor's backward runs under the
    resolved setting, for every output, and the caller's setting is back
    once the backward has left the predictor; the values and the gradient
    are the function's own."""
    monkeypatch.delenv(precision.ENV_VAR, raising=False)
    flags = lambda: (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)  # noqa: E731
    saved = flags()
    caller = (not inside, not inside)
    try:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = caller[0]

        def net(module, images):
            h = _RecordTF32.apply(images * 2.0)
            return [h, (h ** 2).sum(dim=1)]

        fn = precision.with_predictor_precision(net, config_value, fallback="highest")
        x = torch.arange(6.0).reshape(2, 3).requires_grad_(True)
        _RecordTF32.seen = []
        out = fn(None, x)
        assert flags() == caller
        assert torch.equal(out[0], x * 2.0) and torch.equal(out[1], ((2 * x) ** 2).sum(1))
        _RecordTF32.seen = []
        (out[0].sum() + out[1].sum()).backward()
        assert _RecordTF32.seen == [(inside, inside)]
        assert flags() == caller
        torch.testing.assert_close(x.grad, 2.0 + 8.0 * x.detach(), rtol=0, atol=0)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def test_battery_dtype():
    assert precision.battery_dtype("float32") is torch.float32
    assert precision.battery_dtype("bfloat16") is torch.bfloat16
    assert precision.battery_dtype(torch.bfloat16) is torch.bfloat16
    # int8 is a storage dtype: the battery computes in bf16, as the JAX step
    assert precision.battery_dtype("int8") is torch.int8
    assert precision.battery_dtype(torch.int8) is torch.int8
    assert precision.battery_compute_dtype("int8") is torch.bfloat16
    assert precision.battery_compute_dtype("float32") is torch.float32
    # float16 stores and computes in float16, as the JAX step
    assert precision.battery_dtype("float16") is torch.float16
    assert precision.battery_dtype(torch.float16) is torch.float16
    assert precision.battery_compute_dtype("float16") is torch.float16
    # float64 is refused (the JAX package would run it as float32 without x64)
    for bad in ("float64", torch.float64, "half"):
        with pytest.raises(ValueError):
            precision.battery_dtype(bad)
