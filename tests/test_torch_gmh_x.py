"""ScoreNetworkX_GMH in the port against the JAX package, on the CPU.

* The network unfused and fused (and fused with the sampler's bf16-score
  lowering, which ``with_fused`` sets for it as for ScoreNetworkA) on JAX
  parameters carried across by ``ccsd_tpu_torch.utils.from_jax``, at the
  widths of the JAX package's own test (tests/models/test_fused_attention.py:
  61-73: depth 3, nhid 32, adim 32, channels 2 -> 8 -> 4, 4 heads; F = 11,
  B = 4, N = 20 with ragged flags), within rtol = atol = 1e-5 (bf16 scores:
  the bound of tests/test_torch_fused_models.py's fast network).
* ``load_model_params``, ``with_fused`` and the registry's fused set equal
  to JAX's; the state dict round-trips through the JAX converter.
* One epoch through ``Trainer`` (two steps at batch 4 on 8 training
  graphs, then the test losses under the EMA weights) from the JAX init
  on the JAX draws, against the JAX trainer's steps, with
  tests/test_torch_trainer.py's tolerances.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ccsd_tpu.diffusion.losses import get_sde_loss_fn as jget_sde_loss_fn
from ccsd_tpu.diffusion.sde import load_sde as jload_sde
from ccsd_tpu.models.registry import FUSED_CAPABLE as jFUSED_CAPABLE
from ccsd_tpu.models.registry import load_model as jload_model
from ccsd_tpu.models.registry import load_model_params as jload_model_params
from ccsd_tpu.models.registry import with_fused as jwith_fused
from ccsd_tpu.ops import masks as jmasks
from ccsd_tpu.training.ema import ema_init
from ccsd_tpu.training.optim import make_optimizer as jmake_optimizer
from ccsd_tpu.training.trainer import Trainer as JTrainer
from ccsd_tpu.utils.config import get_config as jget_config
from ccsd_tpu.utils.torch_convert import convert

from ccsd_tpu_torch.models.registry import (
    FUSED_CAPABLE,
    load_model,
    load_model_params,
    with_fused,
)
from ccsd_tpu_torch.models.score_x import ScoreNetworkX_GMH
from ccsd_tpu_torch.training.ema import EMA
from ccsd_tpu_torch.training.trainer import Trainer
from ccsd_tpu_torch.utils.config import get_config
from ccsd_tpu_torch.utils.from_jax import load_jax_params, state_dict_from_jax

from test_torch_fused_models import BF16_NET_TOL, _inputs, _perturb_biases, _t
from test_torch_train_parity import _perturb, small_configs
from test_torch_trainer import ring_adjs, small_config

TOL = dict(rtol=1e-5, atol=1e-5)
# the JAX package's test widths (tests/models/test_fused_attention.py:61-64)
GMH = dict(model_type="ScoreNetworkX_GMH", max_feat_num=11, depth=3, nhid=32,
           num_linears=2, c_init=2, c_hid=8, c_final=4, adim=32, num_heads=4, conv="GCN",
           use_bn=False, is_cc=False)


def _jax_draws(key, x, adj, sde_adj, eps):
    """The JAX loss's draws (ccsd_tpu/diffusion/losses.py:127-139) for a
    batch of any size."""
    k_t, k_zx, k_zadj = jax.random.split(key, 3)
    x, adj = jnp.asarray(x), jnp.asarray(adj)
    t = jax.random.uniform(k_t, (x.shape[0],), dtype=adj.dtype) * (sde_adj.T - eps) + eps
    flags = jmasks.node_flags(adj)
    return [_t(np.asarray(v)) for v in (t, jmasks.gen_noise(k_zx, x, flags, sym=False),
                                        jmasks.gen_noise(k_zadj, adj, flags, sym=True))]


def _gmh(fused, fast=False, seed=7):
    d = jwith_fused({"x": GMH}, True, fast=fast)["x"] if fused else dict(GMH)
    assert with_fused({"x": GMH}, True, fast=fast)["x"] == d if fused else True
    jm = jload_model(d)
    p = _perturb_biases(jm.init(jax.random.PRNGKey(seed)))
    return jm, p, load_jax_params(load_model(d), p), d


@pytest.mark.parametrize("fused,fast", [(False, False), (True, False), (True, True)],
                         ids=["unfused", "fused_f32", "fused_fast"])
def test_score_network_x_gmh_matches_jax(fused, fast):
    jm, p, m, d = _gmh(fused, fast)
    assert isinstance(m, ScoreNetworkX_GMH) and m.layers[0].fused == fused
    assert d.get("scores_impl") == ("mulreduce_h_bf16" if fast else None)
    x, adj, flags = _inputs(11, seed=8)
    ref = jax.jit(lambda p, x, a, f: jm.apply(p, x, a, flags=f))(
        p, jnp.asarray(x), jnp.asarray(adj), jnp.asarray(flags))
    with torch.no_grad():
        out = m(_t(x), _t(adj), _t(flags))
    assert out.shape == (*x.shape[:2], 11) and not out.numpy()[flags == 0].any()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **(BF16_NET_TOL if fast else TOL))


def test_score_network_x_gmh_weights_round_trip():
    jm, p, m, _ = _gmh(False)
    sd = {k: v.numpy() for k, v in m.state_dict().items()}
    assert set(sd) == set(state_dict_from_jax(m, p))
    tree = convert(jm, sd)
    jax.tree.map(np.testing.assert_array_equal, tree, jax.tree.map(np.asarray, p))


@pytest.mark.parametrize("fused", [False, True])
def test_gmh_definitions_match_jax(fused):
    jcfg, cfg = jget_config("community_small", 0), get_config("community_small", 0)
    for c in (jcfg, cfg):
        c.model.x = "ScoreNetworkX_GMH"
        c.model.fused = fused
    jdefs, pdefs = jload_model_params(jcfg), load_model_params(cfg)
    assert pdefs == jdefs and pdefs[0]["model_type"] == "ScoreNetworkX_GMH"
    for enable, fast in ((True, True), (True, False), (False, True)):
        named = dict(zip(("x", "adj"), pdefs))
        assert with_fused(named, enable, fast) == jwith_fused(named, enable, fast)
    assert FUSED_CAPABLE == jFUSED_CAPABLE


def test_one_gmh_epoch_matches_the_jax_trainer():
    """Two steps at batch 4 (an epoch of 8 training graphs) of ScoreNetworkX_GMH
    and ScoreNetworkA, then the test losses under the EMA weights: each
    step's losses within rtol = 1e-4, every parameter, Adam moment and EMA
    shadow after the epoch within rtol = 1e-4, atol = 1e-6."""
    jcfg, cfg = small_configs()
    for c in (jcfg, cfg):
        c.model.x = "ScoreNetworkX_GMH"
    small_config(cfg)
    tc = jcfg.train
    trainer = Trainer(cfg, device="cpu", adjs=ring_adjs(10), log=False)
    assert len(trainer.train_loader) == 2
    assert isinstance(trainer.models["x"], ScoreNetworkX_GMH)
    jms = [jload_model(d) for d in jload_model_params(jcfg)]
    ps = [_perturb(m.init(jax.random.PRNGKey(30 + i)), 30 + i) for i, m in enumerate(jms)]
    names = ("x", "adj")
    for n, p in zip(names, ps):
        load_jax_params(trainer.models[n], p)
        trainer.emas[n] = EMA(trainer.models[n], tc.ema)

    jt = object.__new__(JTrainer)
    jt.names, jt.is_cc = list(names), False
    jsdes = [jload_sde(jcfg.sde[n]) for n in names]
    jt.loss_fn = jget_sde_loss_fn(*jsdes, *jms, reduce_mean=tc.reduce_mean, eps=tc.eps)
    opt = dict(lr=tc.lr, weight_decay=tc.weight_decay, grad_norm=tc.grad_norm,
               lr_schedule=tc.lr_schedule, lr_decay=tc.lr_decay, steps_per_epoch=2)
    jt.optimizers = {n: jmake_optimizer(**opt) for n in names}
    step, eval_step = jax.jit(jt._make_train_step()), jax.jit(jt._make_eval_step())
    params = dict(zip(names, ps))
    opts = {n: jt.optimizers[n].init(params[n]) for n in names}
    emas = {n: ema_init(params[n], tc.ema) for n in names}
    keys = iter(jax.random.split(jax.random.PRNGKey(5), 3))

    def feed(x, adj):
        key = next(keys)
        d = _jax_draws(key, x.numpy(), adj.numpy(), jsdes[1], tc.eps)
        trainer.loss_fn.draw = lambda *a: d
        return key

    for x, adj in trainer.train_loader:
        key = feed(x, adj)
        params, opts, emas, jl = step(params, opts, emas,
                                      (jnp.asarray(x.numpy()), jnp.asarray(adj.numpy())), key)
        got = trainer.train_step(x, adj)
        np.testing.assert_allclose(got.numpy(), np.asarray(jl), rtol=1e-4)
    for n in names:
        trainer.emas[n].copy_to(trainer.eval_models[n])
    (x, adj), = list(trainer.test_loader)
    key = feed(x, adj)
    want = eval_step(emas, (jnp.asarray(x.numpy()), jnp.asarray(adj.numpy())), key)
    np.testing.assert_allclose(trainer.eval_step(x, adj).numpy(), np.asarray(want), rtol=1e-4)

    tol = dict(rtol=1e-4, atol=1e-6)
    for n in names:
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
            for what, got in (("param", p), ("mu", st["exp_avg"]), ("nu", st["exp_avg_sq"]),
                              ("ema", shadow[name])):
                np.testing.assert_allclose(got.detach().numpy(), refs[what][name],
                                           err_msg=f"{n} {name} {what}", **tol)

