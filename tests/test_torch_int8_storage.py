"""Int8 storage of the predictor battery (``losses/int8_storage.py``, the
``dequant_int8`` kernel's plain version, ``predictor_dtype: "int8"`` in
``g_step`` and the trainer) against the JAX package, and the three tools of
this slice at their small sizes on the CPU.

  - Quantisation: the port's store against the JAX ``cast_predictor_params(
    state_dict_to_flax(...), "int8")``, leaf for leaf: ``q`` bitwise and
    ``s`` equal, at full size for Hopenet, ESR-9 and the R-Net (the R-Net's
    sharing kept on both sides); ArcFace, DEX and the hair net by their key
    and shape map (every floating tensor one JAX leaf of the JAX init's
    shape), which is all the quantisation needs, since it is elementwise
    with one scale per tensor.
  - Dequantisation: the store's plain dequantisation against the JAX
    ``dequantize_predictor_params``, bitwise in bf16 and in f32, at ragged
    tensor sizes.
  - ``g_step``: the port's int8 step bitwise equal to its bf16 step on the
    dequantised weights; against the JAX int8 step on
    ``test_torch_attr_train``'s Hopenet and R-Net gamma setup, the losses to
    ``INT8_LOSS_RTOL``.
"""

import copy
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gan_control_tpu.losses import registry as j_registry
from gan_control_tpu.training.train_step import TrainStepConfig as JStepConfig
from gan_control_tpu.training.train_step import make_train_steps

from gan_control_torch import train_generator
from gan_control_torch.data.datasets import synthetic_data_loader
from gan_control_torch.losses.int8_storage import Int8Battery, quantized_keys
from gan_control_torch.losses.predictors import predictor_module
from gan_control_torch.losses.predictors.common import init_predictor_
from gan_control_torch.losses.registry import build_attr_losses, cast_predictor_params, distinct_predictors
from gan_control_torch.ops import kernels
from gan_control_torch.tools import battery_share, loader_bench, profile_bench
from gan_control_torch.trainers.generator_trainer import GeneratorTrainer
from gan_control_torch.training import train_step as ts

from test_torch_attr_train import FFHQ, attr_setup  # noqa: F401  (a fixture)
from test_torch_train import (  # noqa: F401  (models: a fixture)
    BATCH,
    J_SPEC,
    STYLE,
    T_SPEC,
    _capture,
    _port_state,
    _t,
    _tiny_config,
    models,
)

TC = FFHQ["training_config"]
# the port's int8 g_step against the JAX one: both run the battery in bf16
# (the same dequantised weights, the same bf16 images), through other conv
# and matmul implementations with f32 accumulation; bf16 rounds each
# activation to 2**-8 relative, so the two drift apart by a few bf16 steps
# over 50 layers (measured on the CPU: 2.8e-3 for Hopenet's loss, 6.8e-3
# for the R-Net's gamma loss, 7e-8 for the adversarial loss)
INT8_LOSS_RTOL = 2e-2


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch thread: the suite runs six workers on the box's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _net(name: str, seed: int):
    net = predictor_module(name).make_model(TC[name]).eval().requires_grad_(False)
    return init_predictor_(net, seed).to(memory_format=torch.channels_last)


def _leaves(tree, prefix=()):
    """(path, leaf) of a nested dict; a JAX ``{"q", "s"}`` pair is a leaf."""
    for key, val in tree.items():
        if hasattr(val, "items") and set(val) != {"q", "s"}:
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return (a.astype(np.float32) if a.dtype != np.float32 else a).view(np.uint32)


# ---------------------------------------------------------------------------
# quantisation against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["orientation_loss", "expression_loss", "recon_3d_loss"])
def test_store_matches_the_jax_quantisation_leaf_for_leaf(name):
    """Every leaf of the JAX int8 tree against the port's stored tensor
    that ``state_dict_to_flax`` maps to it: ``q`` bitwise, ``s`` equal.
    The R-Net under two loss names is stored once on both sides."""
    mod = predictor_module(name)
    net = _net(name, 3)
    flax_tree = mod.state_dict_to_flax(net.state_dict())
    shared = name == "recon_3d_loss"
    names = [name, "recon_gamma_loss"] if shared else [name]
    j_int8 = j_registry.cast_predictor_params({n: flax_tree for n in names}, "int8")
    battery = Int8Battery({n: net for n in names})
    if shared:
        assert j_int8["recon_gamma_loss"] is j_int8["recon_3d_loss"]
        nets = battery.nets()
        assert nets["recon_gamma_loss"] is nets["recon_3d_loss"]
    stored = battery.quantized(name)
    assert battery.num_tensors == len(stored) == len(quantized_keys(net))
    q_tree = mod.state_dict_to_flax({k: q.float() for k, (q, _) in stored.items()})
    s_tree = mod.state_dict_to_flax({k: s.expand(q.shape) for k, (q, s) in stored.items()})
    j_leaves = dict(_leaves(j_int8[name]))
    q_leaves, s_leaves = dict(_leaves(q_tree)), dict(_leaves(s_tree))
    assert set(j_leaves) == set(q_leaves) == set(s_leaves)
    for path, leaf in j_leaves.items():
        assert np.asarray(leaf["q"]).dtype == np.int8, path
        np.testing.assert_array_equal(np.asarray(leaf["q"]).astype(np.float32), q_leaves[path],
                                      err_msg=str(path))
        assert np.all(s_leaves[path] == np.float32(leaf["s"])), path
    # the modules keep no float copy
    assert all(t.device.type == "meta" for t in (*net.parameters(), *net.buffers()))


@pytest.mark.parametrize("name", ["embedding_loss", "age_loss", "hair_loss"])
def test_every_floating_tensor_maps_to_one_jax_leaf(name):
    """Each tensor that int8 storage quantises goes to exactly one leaf of
    ``state_dict_to_flax`` whole (each leaf takes one tensor's values), and
    the leaves are those of the JAX net's init, shape for shape."""
    mod = predictor_module(name)
    net = mod.make_model(TC[name])
    sd = net.state_dict()
    keys = quantized_keys(net)
    assert keys == [k for k, v in sd.items() if v.is_floating_point()] and len(keys) == len(sd)
    marked = {k: torch.full((1,), float(i)).expand(sd[k].shape) for i, k in enumerate(keys)}
    leaves = dict(_leaves(mod.state_dict_to_flax(marked)))
    markers = sorted(int(leaf.flat[0]) for leaf in leaves.values())
    assert markers == list(range(len(keys)))
    for path, leaf in leaves.items():
        assert leaf.min() == leaf.max(), path
        assert leaf.size == sd[keys[int(leaf.flat[0])]].numel(), path
    j_mod = j_registry._load_predictor(j_registry.PREDICTOR_MODULES[name])
    j_model = j_mod.make_model(TC[name])
    shapes = jax.eval_shape(lambda k: j_mod.init_params(j_model, k), jax.random.PRNGKey(0))
    j_shapes = {p: tuple(v.shape) for p, v in _leaves(shapes)}
    assert j_shapes == {p: leaf.shape for p, leaf in leaves.items()}


# ---------------------------------------------------------------------------
# dequantisation against JAX
# ---------------------------------------------------------------------------


class _Ragged(torch.nn.Module):
    """Tensors of ragged sizes: below, at and past a kernel block, a
    channels_last conv, all zeros, and empty."""

    def __init__(self):
        super().__init__()
        rng = np.random.default_rng(5)
        block = kernels.DEQUANT_BLOCK
        shapes = [(3,), (block,), (block + 1,), (17, 5, 3, 3), (2, block - 1)]
        for i, s in enumerate(shapes):
            self.register_parameter(f"p{i}", torch.nn.Parameter(
                torch.from_numpy(rng.standard_normal(s).astype(np.float32) * (i + 1)), requires_grad=False))
        self.p3.data = self.p3.data.to(memory_format=torch.channels_last)
        self.register_buffer("zeros", torch.zeros(40))
        self.register_buffer("empty", torch.zeros(0, 3))
        self.register_buffer("steps", torch.arange(4))  # not floating: not quantised


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dequantisation_matches_jax_bitwise(dtype):
    """``(q * s).to(dtype)`` per tensor, bitwise as the JAX
    ``dequantize_predictor_params``; segments aligned to the kernel's
    blocks, padding zero; the non-floating buffer stays in the module."""
    net = _Ragged()
    battery = Int8Battery({"x": net})
    assert net.steps.device.type == "cpu" and battery.num_tensors == 7
    assert all(off % kernels.DEQUANT_BLOCK == 0 and n % kernels.DEQUANT_BLOCK == 0 for off, n in battery.segments)
    flat = battery.dequantize(dtype)
    assert flat.dtype == dtype and flat.shape == battery.q.shape
    views = battery.nets(dtype)["x"].tensors
    j_dtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    for key, (q, s) in battery.quantized("x").items():
        if q.numel() == 0:
            assert views[key].shape == (0, 3)
            continue
        want = j_registry.dequantize_predictor_params(
            {"t": {"q": jnp.asarray(q.contiguous().numpy()), "s": jnp.float32(s.item())}}, j_dtype)["t"]
        got = views[key]
        assert got.stride() == q.stride(), key
        np.testing.assert_array_equal(_bits(got.float().contiguous().numpy()), _bits(want), err_msg=key)
    assert float(battery.quantized("x")["zeros"][1]) == 1.0
    used = torch.zeros(flat.numel(), dtype=torch.bool)
    for key, (q, _) in battery.quantized("x").items():
        off = q.storage_offset()
        used[off:off + q.numel()] = True
    assert not flat[~used].any()


def test_one_launch_per_dequantisation(monkeypatch):
    """Through the launcher (the plain version counting in its place), one
    launch dequantises the whole store, and a net's evaluation copy takes
    one more over that net's blocks alone."""
    net = _Ragged()
    other = torch.nn.Linear(3, 5)
    battery = Int8Battery({"x": net, "y": other, "z": net})
    want = battery.dequantize()

    def counting(*a):
        kernels.dequant_int8.launches += 1
        return kernels.dequant_int8_plain(*a)

    monkeypatch.setattr(kernels, "_plain_path", lambda x: False)
    monkeypatch.setattr(kernels, "_cuda_dequant_int8", counting)
    kernels.reset_launch_counts()
    nets = battery.nets()
    assert kernels.launch_counts()["dequant_int8"] == 1
    assert nets["x"] is nets["z"] and nets["y"] is not nets["x"]
    assert torch.equal(nets["y"].tensors["weight"], want[battery.segments[7][0]:][:15].view(5, 3))
    lin = battery.float_module("y")
    assert kernels.launch_counts()["dequant_int8"] == 2
    q, s = battery.quantized("y")["weight"]
    assert lin.weight.dtype == torch.float32 and torch.equal(lin.weight, q.float() * s)
    assert other.weight.device.type == "meta"


# ---------------------------------------------------------------------------
# g_step
# ---------------------------------------------------------------------------


def _bf16_on_dequantised(battery: Int8Battery, float_predictors: dict) -> dict:
    """A bf16 battery of the same modules holding the int8 store's
    dequantised values, in the modules' own layouts."""
    out = copy.deepcopy(float_predictors)
    nets = battery.nets(torch.bfloat16)
    with torch.no_grad():
        for name, m in distinct_predictors(out).items():
            m.to(torch.bfloat16)
            sd = m.state_dict()
            for key, view in nets[name].tensors.items():
                sd[key].copy_(view)
    return out


@pytest.mark.parametrize("remat", [False, True])
def test_int8_g_step_is_the_bf16_step_on_the_dequantised_weights(models, attr_setup, remat):
    """Losses and every G gradient bitwise; the store is unchanged by the
    step and the modules still hold no float copy."""
    z, inj, _, _, t_specs, t_predictors = attr_setup
    battery = cast_predictor_params(copy.deepcopy(t_predictors), "int8")
    assert isinstance(battery, Int8Battery)
    ref = _bf16_on_dequantised(battery, t_predictors)
    q, scales = battery.q.clone(), battery.scales.clone()
    out = {}
    for label, dtype, preds in (("int8", "int8", battery), ("bf16", "bfloat16", ref)):
        ps = _port_state(models)
        cfg = ts.TrainStepConfig(batch=BATCH, mini_batch=BATCH, style_dim=STYLE, remat_predictors=remat,
                                 predictor_dtype=dtype)
        m = ts.g_step(ps, cfg, T_SPEC, (_t(z),), noise=[_t(n) for n in inj], attr_losses=t_specs,
                      predictors=preds)
        out[label] = (m, {n: p.grad for n, p in ps.generator.named_parameters()})
    (m8, g8), (m16, g16) = out["int8"], out["bf16"]
    assert set(m8) == set(m16) == {"g_adv_loss", "g_orientation_loss", "g_recon_gamma_loss", "g_loss"}
    for k in m8:
        assert torch.equal(m8[k], m16[k]), k
    for k in g16:
        assert torch.equal(g8[k], g16[k]), k
    assert torch.equal(battery.q, q) and torch.equal(battery.scales, scales)
    for m in distinct_predictors(battery).values():
        assert all(t.device.type == "meta" for t in (*m.parameters(), *m.buffers()))


def test_int8_g_step_matches_jax(models, attr_setup):
    """The adversarial and both attribute losses of the port's int8 step
    against the JAX int8 step (its params quantised by the JAX
    ``cast_predictor_params``) from the same weights and inputs."""
    jg, jd, g_params, _, _, _ = models
    z, inj, j_specs, j_params, t_specs, t_predictors = attr_setup
    from gan_control_tpu.training.state import init_gan_state as j_init_gan_state

    jcfg = JStepConfig(batch=BATCH, mini_batch=BATCH, style_dim=STYLE, predictor_dtype="int8")
    fns = make_train_steps(jg, jd, jcfg, spec=J_SPEC, attr_losses=j_specs, g_tx=_capture(), d_tx=_capture())
    state = j_init_gan_state(jg, jd, _capture(), _capture(), jax.random.PRNGKey(0), style_dim=STYLE)
    state = state.replace(g_params=jax.tree_util.tree_map(jnp.asarray, g_params))
    _, jm = fns["g_step"](state, (jnp.asarray(z),), j_registry.cast_predictor_params(j_params, "int8"),
                          [jnp.asarray(n) for n in inj])
    battery = cast_predictor_params(copy.deepcopy(t_predictors), "int8")
    cfg = ts.TrainStepConfig(batch=BATCH, mini_batch=BATCH, style_dim=STYLE, predictor_dtype="int8")
    tm = ts.g_step(_port_state(models), cfg, T_SPEC, (_t(z),), noise=[_t(n) for n in inj],
                   attr_losses=t_specs, predictors=battery)
    assert set(tm) == set(jm)
    for k in jm:
        assert float(jm[k]) > 0, k
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=INT8_LOSS_RTOL, err_msg=k)


# ---------------------------------------------------------------------------
# the trainer and the command line
# ---------------------------------------------------------------------------


def _int8_config(tmp_path):
    config = _tiny_config()
    config["results_dir"] = str(tmp_path)
    tc = config["training_config"]
    tc["predictor_dtype"] = "int8"
    for name, block in tc.items():
        if isinstance(block, dict) and block.get("enabled") and name.endswith("_loss"):
            block["enabled"] = name == "recon_3d_loss"
    return config


def test_trainer_holds_int8_between_steps(tmp_path):
    """``GeneratorTrainer`` under ``predictor_dtype: "int8"``: the battery
    becomes one store, ``train(2)`` logs finite attribute losses, the store
    is unchanged and no float copy is resident between steps; an
    evaluation's net is the store dequantised to f32."""
    config = _int8_config(tmp_path)
    specs, predictors = build_attr_losses(config["training_config"], device="cpu", seed=0)
    tr = GeneratorTrainer(config=config, data_loader=synthetic_data_loader(16, 16, seed=3), device="cpu",
                          attr_losses=specs, predictors=predictors)
    battery = tr.predictors
    assert isinstance(battery, Int8Battery) and battery.q.dtype == torch.int8
    assert battery["recon_gamma_loss"] is battery["recon_3d_loss"]
    q, scales = battery.q.clone(), battery.scales.clone()
    tr.train(2)
    names = [f"g_{s.name}" for s in specs]
    for h in tr.metrics_history:
        assert all(n in h and np.isfinite(h[n]) for n in names), h
    assert torch.equal(battery.q, q) and torch.equal(battery.scales, scales)
    for m in distinct_predictors(battery).values():
        assert all(t.device.type == "meta" for t in (*m.parameters(), *m.buffers()))
    rnet = tr._predictor("recon_gamma_loss")
    assert rnet is not battery["recon_gamma_loss"]
    for key, (qt, s) in battery.quantized("recon_3d_loss").items():
        assert torch.equal(rnet.state_dict()[key], qt.float() * s), key
    tr.close()


def test_train_generator_with_int8_storage(tmp_path):
    """``python -m gan_control_torch.train_generator --device cpu`` on an
    int8 config trains and writes its checkpoint."""
    config = _int8_config(tmp_path / "runs")
    config["data_config"] = {"data_set_name": "synthetic"}
    path = tmp_path / "config.json"
    path.write_text(json.dumps(config))
    train_generator.main(["--config_path", str(path), "--iters", "1", "--device", "cpu"])
    ckpts = list((tmp_path / "runs").glob("**/checkpoint/*.ckpt"))
    assert ckpts, list((tmp_path / "runs").rglob("*"))


# ---------------------------------------------------------------------------
# the tools
# ---------------------------------------------------------------------------


def test_battery_share_small(monkeypatch):
    """The four legs on the CPU (one round): every leg timed and counted, the int8
    leg's battery a quarter of the f32 one's bytes (plus the padding, the
    scales and the tables), the adversarial leg without one."""
    monkeypatch.setattr(battery_share, "ROUNDS", 1)
    rows = {r["name"]: r for r in battery_share.main(["--small", "--device", "cpu"])}
    assert list(rows) == list(battery_share.LEGS)
    f32, bf16, int8 = (rows[f"g_step_battery_{d}"] for d in ("f32", "bf16", "int8"))
    assert rows["g_step_adv_only"]["battery_bytes"] == 0 and rows["g_step_adv_only"]["battery_ms"] == 0
    assert bf16["battery_bytes"] * 2 == f32["battery_bytes"]
    assert f32["battery_bytes"] / 4 < int8["battery_bytes"] < f32["battery_bytes"] / 3.5
    for r in rows.values():
        assert r["ms"] > 0 and r["flops"] > 0 and r["bytes"] > 0 and r["peak_bytes"] is None
    # the same convs at the same precision, the kernel's bytes on top
    assert int8["flops"] > bf16["flops"] > rows["g_step_adv_only"]["flops"]


def test_profile_bench_small():
    out = profile_bench.main(["both", "--small", "--step", "g_adv", "--device", "cpu"])
    gen, train = out["gen"], out["train"]
    assert gen["batch"] == 8 and gen["full_ms"] > 0 and gen["mapping_ms"] > 0
    assert train["step"] == "g_adv" and train["batch"] == 16 and train["size"] == 32 and train["ms"] > 0


def test_loader_bench_small():
    rows = loader_bench.main(["--images", "8", "--src", "64", "--size", "32", "--batch", "4",
                              "--batches", "2", "--workers", "1"])
    by = {r["backend"]: r for r in rows}
    assert by["python_pil"]["imgs_per_s"] > 0 and by["python_pil"]["ms_per_batch"] > 0
    native = by["native_cpp"]
    assert "skipped" in native or native["imgs_per_s"] > 0


def test_dequant_int8_checks_its_arguments():
    """The wrapper takes a whole number of blocks of int8, an f32 scale per
    segment and an int32 tensor per block, on one device, into f32 or bf16."""
    block = kernels.DEQUANT_BLOCK
    q, s, t, seg = torch.zeros(2 * block, dtype=torch.int8), torch.ones(1), torch.zeros(2, dtype=torch.int32), \
        [(0, 2 * block)]
    assert kernels.dequant_int8(q, s, t, seg, torch.float32).dtype == torch.float32
    for bad in ((q[:-1], s, t, seg), (q.float(), s, t, seg), (q.view(2, block), s, t, seg),
                (q, s.double(), t, seg), (q, torch.ones(2), t, seg), (q, s, t[:1], seg),
                (q, s, t.long(), seg)):
        with pytest.raises(ValueError):
            kernels.dequant_int8(*bad)
    with pytest.raises(TypeError):
        kernels.dequant_int8(q, s, t, seg, torch.float16)
    with pytest.raises(RuntimeError):
        kernels._cuda_dequant_int8(q, s, t, seg, torch.bfloat16)
