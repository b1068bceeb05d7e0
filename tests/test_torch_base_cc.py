"""The ablation network ScoreNetworkA_Base_CC and its Hodge layers, the CC
trainer on it, and the trainer's on-device dataset, in the port against
the JAX package, on the CPU.

* ``BaselineBlock`` and ``HodgeBaselineLayer`` (as the first, a middle and
  the last layer of a Base_CC stack, ``num_linears_h`` 1 and 2), and the
  whole network unfused and fused, on JAX parameters carried across by
  ``ccsd_tpu_torch.utils.from_jax`` and nudged off the JAX init (which
  zeroes biases): rtol = atol = 1e-5, as tests/test_torch_cc_models.py
  holds the CC layers (the same sizes: N = 8, cells of 3, E = 28, K = 56,
  B = 4 with ragged flags).
* ``load_model_params`` for the six ``*_Base_CC`` configs, equal to JAX's;
  grid_small_Base_CC names ``num_layers_mlp: null``, whose ScoreNetworkF
  neither package builds.
* One community_small_Base_CC epoch through ``Trainer`` against the JAX
  trainer's steps, as tests/test_torch_cc_trainer.py holds
  community_small_CC's (its tolerances).
* The trainer's dataset: the uint8 lift equals the f32 one exactly, and
  ``ArrayDataset`` over the uint8 copy gives the JAX loader's f32 batches
  in its order.
* ``cli`` trains and samples a cut community_small_Base_CC on the CPU.
"""

import json

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from ccsd_tpu.data import loader as jloader
from ccsd_tpu.diffusion.losses import get_sde_loss_fn_cc as jget_sde_loss_fn_cc
from ccsd_tpu.diffusion.sde import load_sde as jload_sde
from ccsd_tpu.models import hodge_nn as jhnn
from ccsd_tpu.models.registry import load_model as jload_model
from ccsd_tpu.models.registry import load_model_params as jload_model_params
from ccsd_tpu.models.registry import with_fused as jwith_fused
from ccsd_tpu.training.ema import ema_init
from ccsd_tpu.training.optim import make_optimizer as jmake_optimizer
from ccsd_tpu.training.trainer import Trainer as JTrainer
from ccsd_tpu.utils.config import get_config as jget_config

from ccsd_tpu_torch import cli
from ccsd_tpu_torch.data.cc_codec import ccs_to_tensors, convert_graphs_to_CCs
from ccsd_tpu_torch.data.loader import ArrayDataset, generated_adjs, lifted_rank2
from ccsd_tpu_torch.eval.graphs import adjs_to_graphs
from ccsd_tpu_torch.models import hodge_nn
from ccsd_tpu_torch.models.registry import load_model, load_model_params, with_fused
from ccsd_tpu_torch.models.score_a_cc import ScoreNetworkA_Base_CC, ScoreNetworkA_CC
from ccsd_tpu_torch.training.ema import EMA
from ccsd_tpu_torch.training.trainer import Trainer
from ccsd_tpu_torch.utils.config import get_config
from ccsd_tpu_torch.utils.from_jax import load_jax_params, state_dict_from_jax

from test_torch_cc_models import B, E, JSPEC, SPEC, SMALL, _perturb, _t, cc_inputs, hodge_in
from test_torch_cc_sampler import ring_adjs, tame_rank2_head  # noqa: F401 (fixture)
from test_torch_cc_trainer import _config, _jax_draws

TOL = dict(rtol=1e-5, atol=1e-5)
NAMES = ("x", "adj", "rank2")
BASE_CONFIGS = ["community_small_Base_CC", "ego_small_Base_CC", "enzymes_small_Base_CC",
                "grid_small_Base_CC", "qm9_Base_CC", "zinc250k_Base_CC"]
# the small stack's Hodge layers: (channels in, block width, channels out)
# of the first, a middle and the last of three (c_init 2, c_hid_h 3,
# c_final_h 2, nhid_h 4, hidden_h 5)
LAYER_DIMS = {"first": (2, 4, 3), "middle": (3, 5, 3), "last": (3, 5, 2)}


def small_base_cc_configs(num_layers_h=2, num_linears_h=1):
    """(JAX config, port config) of community_small_Base_CC cut to the
    widths of tests/test_torch_cc_models.py, its Hodge stack as
    ``LAYER_DIMS``."""
    out = []
    for get in (jget_config, get_config):
        c = get("community_small_Base_CC", 0)
        c.data.max_node_num, c.data.max_feat_num = 8, 5
        for k, v in SMALL.items():
            if k not in ("adim_h", "num_heads_h"):
                c.model[k] = v
        c.model.update(num_layers_h=num_layers_h, num_linears_h=num_linears_h, c_hid_h=3,
                       c_final_h=2, nhid_h=4, hidden_h=5)
        out.append(c)
    return out


def test_baseline_block_matches_jax():
    _, _, r2, _ = cc_inputs(5)
    jm = jhnn.BaselineBlock(E, 6, E)
    p = _perturb(jm.init(jax.random.PRNGKey(5)), 5)
    pm = load_jax_params(hodge_nn.BaselineBlock(E, 6, E), p)
    h = hodge_in(6)
    jr, jh = jm.apply(p, jnp.asarray(h), jnp.asarray(r2), None)
    r, hh = pm(_t(h), _t(r2))
    np.testing.assert_allclose(r.detach().numpy(), np.asarray(jr), **TOL)
    np.testing.assert_allclose(hh.detach().numpy(), np.asarray(jh), **TOL)
    assert set(dict(pm.named_parameters())) == {
        f"mlp_layer.linears.{i}.{w}" for i in (0, 1) for w in ("weight", "bias")}


@pytest.mark.parametrize("position", list(LAYER_DIMS))
@pytest.mark.parametrize("num_linears", [1, 2])
def test_hodge_baseline_layer_matches_jax(position, num_linears):
    cin, width, cout = LAYER_DIMS[position]
    _, _, r2, flags = cc_inputs(6)
    jm = jhnn.HodgeBaselineLayer(num_linears, cin, width, cout, JSPEC)
    p = _perturb(jm.init(jax.random.PRNGKey(6)), 6)
    pm = load_jax_params(hodge_nn.HodgeBaselineLayer(num_linears, cin, width, cout, SPEC), p)
    h = hodge_in(7, C=cin)
    jh, jr = jm.apply(p, jnp.asarray(h), jnp.asarray(r2), jnp.asarray(flags))
    ph, pr = pm(_t(h), _t(r2), _t(flags))
    assert ph.shape == (B, cout, E, E) and pr.shape == r2.shape
    np.testing.assert_allclose(ph.detach().numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(pr.detach().numpy(), np.asarray(jr), **TOL)


def _base_cc_network(fused, num_layers_h, num_linears_h, seed=0):
    jcfg, cfg = small_base_cc_configs(num_layers_h, num_linears_h)
    jdef, pdef = jload_model_params(jcfg, is_cc=True)[1], load_model_params(cfg)[1]
    if fused:
        jdef, pdef = (jwith_fused({"adj": d})["adj"] for d in (jdef, pdef))
        assert jdef == pdef and pdef["fused"] and "scores_impl" not in pdef
    jm = jload_model(jdef)
    p = _perturb(jm.init(jax.random.PRNGKey(seed)), seed)
    return jm, p, load_jax_params(load_model(pdef), p)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("num_layers_h,num_linears_h", [(2, 1), (3, 2)])
def test_base_cc_network_matches_jax(fused, num_layers_h, num_linears_h):
    """The whole network on JAX weights: the graph branch (the kernels'
    plain versions on the CPU), the Hodge branch, the final MLP."""
    x, adj, r2, flags = cc_inputs(8)
    jm, p, pm = _base_cc_network(fused, num_layers_h, num_linears_h, seed=8)
    assert isinstance(pm, ScoreNetworkA_Base_CC) and len(pm.layers_hodge) == num_layers_h
    want = np.asarray(jm.apply(p, jnp.asarray(x), jnp.asarray(adj), jnp.asarray(r2),
                               flags=jnp.asarray(flags)))
    got = pm(_t(x), _t(adj), rank2=_t(r2), flags=_t(flags)).detach().numpy()
    assert got.shape == want.shape == (B, 8, 8)
    np.testing.assert_allclose(got, want, **TOL)
    assert not np.diagonal(got, axis1=1, axis2=2).any() and not got[flags == 0].any()


def test_both_cc_networks_take_one_graph_branch():
    """ScoreNetworkA_CC and ScoreNetworkA_Base_CC build their graph layers
    by one function: the same definition gives the same layers and the
    same seeded weights."""
    jcfg, cfg = small_base_cc_configs(2)
    base = load_model_params(cfg)[1]
    cc = dict(base, model_type="ScoreNetworkA_CC", adim_h=4, num_heads_h=2,
              conv_hodge="HCN")
    cc.pop("hidden_h")
    a = load_model(base, generator=torch.Generator().manual_seed(3))
    b = load_model(cc, generator=torch.Generator().manual_seed(3))
    assert isinstance(b, ScoreNetworkA_CC)
    sa, sb = a.layers.state_dict(), b.layers.state_dict()
    assert list(sa) == list(sb) and all(torch.equal(sa[k], sb[k]) for k in sa)
    with pytest.raises(NotImplementedError, match="observed cell universe"):
        load_model(dict(base, cells=((0, 1, 2),)))


@pytest.mark.parametrize("name", BASE_CONFIGS)
def test_load_model_params_match_jax(name):
    jdefs = jload_model_params(jget_config(name, 0), is_cc=True)
    defs = load_model_params(get_config(name, 0))
    assert [dict(d) for d in defs] == [dict(d) for d in jdefs]
    assert defs[1]["model_type"] == "ScoreNetworkA_Base_CC" and "adim_h" not in defs[1]
    names = ("x", "adj", "rank2")
    fused, jfused = with_fused(dict(zip(names, defs))), jwith_fused(dict(zip(names, jdefs)))
    assert fused["adj"] == jfused["adj"] and fused["adj"]["fused"] is True
    if defs[2]["num_layers_mlp"] is None:  # grid_small_Base_CC: neither package builds F
        with pytest.raises(TypeError):
            jload_model(jdefs[2]).init(jax.random.PRNGKey(0))
        with pytest.raises(TypeError):
            load_model(defs[2])
        return
    m = load_model(defs[1])
    jm = jload_model(jdefs[1])
    got = state_dict_from_jax(m, jm.init(jax.random.PRNGKey(0)))
    assert {k: v.shape for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in m.state_dict().items()}


def test_one_base_cc_epoch_matches_the_jax_trainer():
    """One epoch (two steps at batch 4 on 8 training graphs, then the test
    losses under the EMA weights) from the JAX init on the JAX draws: each
    step's three losses within rtol = 1e-4, and after the epoch every
    parameter, Adam moment and EMA shadow within rtol = 1e-4, atol = 2e-6
    (tests/test_torch_cc_trainer.py)."""
    jcfg, cfg = (_config(c) for c in small_base_cc_configs(2, 2))
    tc = jcfg.train
    trainer = Trainer(cfg, device="cpu", adjs=ring_adjs(10, 8), log=False)
    assert len(trainer.train_loader) == 2 and trainer.names == NAMES
    assert isinstance(trainer.models["adj"], ScoreNetworkA_Base_CC)
    jms = [jload_model(d) for d in jload_model_params(jcfg, is_cc=True)]
    ps = [_perturb(m.init(jax.random.PRNGKey(20 + i)), 20 + i) for i, m in enumerate(jms)]
    for n, p in zip(NAMES, ps):
        load_jax_params(trainer.models[n], p)
        trainer.emas[n] = EMA(trainer.models[n], tc.ema)

    jt = object.__new__(JTrainer)
    jt.names, jt.is_cc = list(NAMES), True
    jsdes = [jload_sde(jcfg.sde[n]) for n in NAMES]
    jt.loss_fn = jget_sde_loss_fn_cc(*jsdes, *jms, JSPEC, reduce_mean=tc.reduce_mean,
                                     eps=tc.eps)
    opt = dict(lr=tc.lr, weight_decay=tc.weight_decay, grad_norm=tc.grad_norm,
               lr_schedule=tc.lr_schedule, lr_decay=tc.lr_decay, steps_per_epoch=2)
    jt.optimizers = {n: jmake_optimizer(**opt) for n in NAMES}
    step, eval_step = jax.jit(jt._make_train_step()), jax.jit(jt._make_eval_step())
    params = dict(zip(NAMES, ps))
    opts = {n: jt.optimizers[n].init(params[n]) for n in NAMES}
    emas = {n: ema_init(params[n], tc.ema) for n in NAMES}
    keys = iter(jax.random.split(jax.random.PRNGKey(4), 3))

    def feed(*batch):
        key = next(keys)
        trainer.loss_fn.draw = lambda *a, d=_jax_draws(key, *batch, jsdes[1], tc.eps): d
        return key

    for batch in trainer.train_loader:
        key = feed(*batch)
        params, opts, emas, jl = step(params, opts, emas,
                                      tuple(jnp.asarray(b.numpy()) for b in batch), key)
        got = trainer.train_step(*batch)
        np.testing.assert_allclose(got.numpy(), np.asarray(jl), rtol=1e-4)
    for n in NAMES:
        trainer.emas[n].copy_to(trainer.eval_models[n])
    (batch,) = list(trainer.test_loader)
    key = feed(*batch)
    want = eval_step(emas, tuple(jnp.asarray(b.numpy()) for b in batch), key)
    got = trainer.eval_step(*batch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)

    tol = dict(rtol=1e-4, atol=2e-6)
    for n in NAMES:
        model = trainer.models[n]
        adam = next(s for s in opts[n] if hasattr(s, "mu"))
        refs = {"param": state_dict_from_jax(model, params[n]),
                "mu": state_dict_from_jax(model, adam.mu),
                "nu": state_dict_from_jax(model, adam.nu),
                "ema": state_dict_from_jax(model, emas[n].shadow_params)}
        shadow = dict(zip([k for k, _ in model.named_parameters()],
                          trainer.emas[n].shadow_params))
        for name, p in model.named_parameters():
            st = trainer.optimizers[n].adam.state[p]
            for what, v in (("param", p), ("mu", st["exp_avg"]), ("nu", st["exp_avg_sq"]),
                            ("ema", shadow[name])):
                np.testing.assert_allclose(v.detach().numpy(), refs[what][name],
                                           err_msg=f"{n} {name} {what}", **tol)


@pytest.mark.parametrize("data,N", [("community_small_CC", 20), ("grid_small_CC", 16)])
def test_uint8_lift_is_exact(data, N):
    """The lift written into uint8 equals ``ccs_to_tensors``' f32 incidences
    (grid_small_CC's graphs up to 4 × 4 here: the 49-node lift is 86 MB a
    graph in f32)."""
    cfg = get_config(data, 0)
    cfg.data.max_node_num = N
    adjs = generated_adjs(data, 0, 49 if data == "grid_small_CC" else 20)
    n = (adjs.sum(-1) > 0).sum(-1)
    adjs = adjs[n <= N][:12, :N, :N]
    want = ccs_to_tensors(convert_graphs_to_CCs(adjs_to_graphs(adjs), lifting_procedure=
                                                cfg.data.lifting_procedure,
                                                lifting_procedure_kwargs="basic"), N, 3, 3)[1]
    got = lifted_rank2(adjs, cfg.data, np.uint8)
    assert got.dtype == np.uint8 and got.any() and len(got) == len(adjs) > 0
    np.testing.assert_array_equal(got.astype(np.float32), want)
    np.testing.assert_array_equal(lifted_rank2(adjs, cfg.data), want)


def test_uint8_lift_refuses_entries_it_cannot_hold(monkeypatch):
    import ccsd_tpu_torch.data.cc_codec as codec

    cfg = get_config("community_small_CC", 0)
    adjs = generated_adjs("community_small_CC", 0, 20)[:2]
    real = codec.pad_rank2
    monkeypatch.setattr(codec, "pad_rank2", lambda *a: real(*a) * 0.5)
    with pytest.raises(ValueError, match="does not fit uint8"):
        lifted_rank2(adjs, cfg.data, np.uint8)


@pytest.mark.parametrize("bs", [3, 4])
def test_device_dataset_gives_the_numpy_batches(bs):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((10, 4, 2)).astype(np.float32)
    r = (rng.random((10, 5, 6)) < 0.3).astype(np.uint8)
    host = jloader.ArrayDataset([x, r.astype(np.float32)], bs, seed=7)
    dev = ArrayDataset([x, r], bs, seed=7, device="cpu")
    assert dev.arrays[1].dtype == torch.uint8 and len(dev) == len(host)
    for _ in range(3):  # three passes: the same draws of the order
        for (hx, hr), (dx, dr) in zip(host, dev):
            assert dx.dtype == dr.dtype == torch.float32
            np.testing.assert_array_equal(dx.numpy(), hx)
            np.testing.assert_array_equal(dr.numpy(), hr)


def test_cc_trainer_holds_its_dataset_on_its_device():
    cfg = _config(small_base_cc_configs()[1])
    trainer = Trainer(cfg, device="cpu", adjs=ring_adjs(10, 8), log=False)
    for loader in (trainer.train_loader, trainer.test_loader):
        assert [a.dtype for a in loader.arrays] == [torch.float32, torch.float32, torch.uint8]
        assert all(a.device == trainer.device for a in loader.arrays)


def test_cli_trains_and_samples_base_cc(tmp_path, capsys, tame_rank2_head):
    """A community_small_Base_CC config cut to tiny widths and 2 epochs,
    trained and then sampled by the protocol (divide_batch 4 of batch 8:
    one round of 2) on the CPU."""
    (tmp_path / "config").mkdir()
    cfg = small_base_cc_configs()[1]
    cfg.train.update(num_epochs=2, save_interval=2, print_interval=1)
    cfg.data.batch_size = 8
    cfg.model.num_layers_mlp = 1  # the form tame_rank2_head scales
    cfg.sample.score_dtype = "f32"  # the f32 networks (community_small_CC's data: bf16 by default)
    for k in NAMES:
        cfg.sde[k].num_scales = 3
    with open(tmp_path / "config" / "tiny_base_cc.yaml", "w") as f:
        yaml.safe_dump(cfg.to_dict(), f)
    np.save(tmp_path / "adjs.npy", ring_adjs(10, 8))
    common = ["--config", "tiny_base_cc", "--folder", str(tmp_path), "--device", "cpu",
              "--train-adjs", str(tmp_path / "adjs.npy")]
    assert cli.main(["--type", "train", *common]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["epochs"] == 2 and np.isfinite(report["train_loss_adj"])
    assert cli.main(["--type", "sample", *common, "--ckpt", report["ckpt"]]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["samples"] == 2 and report["finite"] and "cells_per_cc" in report
    assert set(report["cc_mmd"]) >= {"hodge_laplacian_spectrum"}
