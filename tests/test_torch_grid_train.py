"""grid (N = 361) training in the port against the JAX package, on the CPU.

* The plain backwards the tiled backward kernels are held to on the card
  (``gcn_aggregate_bwd_plain``, ``gmh_attention_bwd_plain``) past the
  one-block kernels, at N = 65, 100 (ragged last tiles) and grid's 361,
  against ``jax.grad`` of the reference layers ``DenseGCNConv.apply``
  (ccsd_tpu/models/gcn.py) and ``Attention.apply``
  (ccsd_tpu/models/attention.py) on the same numpy inputs and weights, in
  f32: |got - ref| <= 1e-5 (|ref| + max |ref|) per gradient, the scaled
  bound of tests/test_torch_train_parity.py (one layer of f32 rounding).
* One training step of grid's loss at N = 361 and narrow widths
  (ScoreNetworkX depth 2, nhid 8; ScoreNetworkA 2 AttentionLayers, channels
  2 -> 4 -> 2, adim 8, 4 heads) on one of grid's generated training
  graphs: in f32 the port's losses against the JAX loss on the same JAX
  draws (rtol = 1e-5); in float64 (``jax.enable_x64``, the port's
  networks in double) the loss (rtol = 1e-12) and every parameter's
  gradient against ``jax.grad`` through ``state_dict_from_jax`` (the
  scaled bound at 1e-9; measured 2e-11).  The gradients are not compared
  in f32: at N = 361 the noisy adjacencies' degree sums cancel, and an f32
  gradient of either package lies up to ~2e-2 of its largest entry from
  float64 (measured on the CPU, both packages alike).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ccsd_tpu.diffusion.losses import get_sde_loss_fn as jget_sde_loss_fn
from ccsd_tpu.diffusion.sde import load_sde as jload_sde
from ccsd_tpu.models.attention import Attention as JAttention
from ccsd_tpu.models.gcn import DenseGCNConv as JDenseGCNConv
from ccsd_tpu.models.registry import load_model as jload_model
from ccsd_tpu.models.registry import load_model_params as jload_model_params
from ccsd_tpu.ops import masks as jmasks
from ccsd_tpu.utils.config import get_config as jget_config

from ccsd_tpu_torch.data.loader import generated_adjs, init_features, split
from ccsd_tpu_torch.diffusion.losses import get_sde_loss_fn
from ccsd_tpu_torch.diffusion.sde import load_sde
from ccsd_tpu_torch.kernels.gcn import gcn_aggregate_bwd_plain
from ccsd_tpu_torch.kernels.gmh_attention import gmh_attention_bwd_plain
from ccsd_tpu_torch.models.registry import load_model, load_model_params
from ccsd_tpu_torch.utils.config import get_config
from ccsd_tpu_torch.utils.from_jax import load_jax_params, state_dict_from_jax

from test_torch_grid import _draws
from test_torch_train_parity import _perturb, _t, _tie_adj, grad_ok

NARROW = {"depth": 2, "nhid": 8, "num_layers": 2, "c_init": 2, "c_hid": 4, "c_final": 2,
          "adim": 8, "num_heads": 4}


@pytest.mark.parametrize("B,N", [(2, 65), (2, 100), (1, 361)])
@pytest.mark.parametrize("add_loop", [True, False])
def test_gcn_plain_backward_matches_jax_grad_past_one_block(B, N, add_loop):
    rng = np.random.default_rng(N)
    Fi, Fo = 5, 7
    x = rng.standard_normal((B, N, Fi)).astype(np.float32)
    adj = _tie_adj((B, N, N), rng)
    g = rng.standard_normal((B, N, Fo)).astype(np.float32)
    conv = JDenseGCNConv(Fi, Fo)
    p = _perturb(conv.init(jax.random.PRNGKey(0)), 0)

    def f(p, x, adj):
        return jnp.sum(conv.apply(p, x, adj, add_loop=add_loop) * g)

    dp, dx, dadj = jax.grad(f, argnums=(0, 1, 2))(p, jnp.asarray(x), jnp.asarray(adj))
    got = gcn_aggregate_bwd_plain(_t(x), _t(adj), _t(p["weight"]), _t(g), 1.0, add_loop)
    for a, r in zip(got, (dx, dadj, dp["weight"], dp["bias"])):
        assert grad_ok(a.numpy(), np.asarray(r), 1e-5), np.abs(a.numpy() - r).max()


@pytest.mark.parametrize("B,N", [(2, 65), (1, 100), (1, 361)])
def test_gmh_plain_backward_matches_jax_grad_past_one_block(B, N):
    """Per channel, jax.grad of Attention.apply (value and map) against the
    plain backward of both channels at once (C = 2, F_in 5, attn 8, F_out
    6, 4 heads); x's gradient sums the channels'."""
    rng = np.random.default_rng(N + 1)
    C, Fi, A, O, H = 2, 5, 8, 6, 4
    x = rng.standard_normal((B, N, Fi)).astype(np.float32)
    adj = _tie_adj((B, C, N, N), rng)
    gv = rng.standard_normal((B, N, C * O)).astype(np.float32)
    ga = rng.standard_normal((B, N, N, C)).astype(np.float32)
    att = JAttention(Fi, A, O, num_heads=H, conv="GCN")
    ps = [_perturb(att.init(jax.random.PRNGKey(c)), c) for c in range(C)]
    dx_ref, refs = 0, []
    for c, p in enumerate(ps):
        def f(p, x, a):
            v, m = att.apply(p, x, a, None)
            return jnp.sum(v * gv[..., c * O:(c + 1) * O]) + jnp.sum(m * ga[..., c])

        dp, dx, da = jax.grad(f, argnums=(0, 1, 2))(p, jnp.asarray(x), jnp.asarray(adj[:, c]))
        dx_ref = dx_ref + np.asarray(dx)
        refs.append((dp, np.asarray(da)))
    st = lambda m, leaf: _t(np.stack([np.asarray(p[m][leaf]) for p in ps]))  # noqa: E731
    got = gmh_attention_bwd_plain(_t(x), _t(adj), st("q", "weight"), st("q", "bias"),
                                  st("k", "weight"), st("k", "bias"), st("v", "weight"),
                                  st("v", "bias"), _t(gv), _t(ga), H, O)
    assert grad_ok(got[0].numpy(), dx_ref, 1e-5)
    for c, (dp, da) in enumerate(refs):
        assert grad_ok(got[1][:, c].numpy(), da, 1e-5), np.abs(got[1][:, c].numpy() - da).max()
        for i, (m, leaf) in enumerate([(m, leaf) for m in "qkv" for leaf in ("weight", "bias")]):
            assert grad_ok(got[2 + i][c].numpy(), np.asarray(dp[m][leaf]), 1e-5), (c, m, leaf)


def _x64_draws(key, x, adj, sde_adj, eps):
    """The JAX loss's draws (ccsd_tpu/diffusion/losses.py:127-139) in
    float64, under ``jax.enable_x64``."""
    k_t, k_zx, k_zadj = jax.random.split(key, 3)
    t = jax.random.uniform(k_t, (adj.shape[0],), dtype=adj.dtype) * (sde_adj.T - eps) + eps
    flags = jmasks.node_flags(adj)
    return [torch.from_numpy(np.array(v)) for v in
            (t, jmasks.gen_noise(k_zx, x, flags, sym=False),
             jmasks.gen_noise(k_zadj, adj, flags, sym=True))]


def test_grid_train_step_matches_jax_loss_and_grad():
    jcfg, cfg = jget_config("grid", 0), get_config("grid", 0)
    for c in (jcfg, cfg):
        for k, v in NARROW.items():
            c.model[k] = v
    N = int(cfg.data.max_node_num)
    assert N == 361
    adjs = generated_adjs("grid", int(cfg.get("seed", 42)), N)
    adj = adjs[split(len(adjs), float(cfg.data.test_split))[0]][:1]
    x = init_features(cfg.data.init, adj, int(cfg.data.max_feat_num))
    jms = [jload_model(d) for d in jload_model_params(jcfg)]
    ps = [_perturb(m.init(jax.random.PRNGKey(30 + i)), 30 + i) for i, m in enumerate(jms)]
    defs = load_model_params(cfg)
    eps = float(cfg.train.eps)
    jsdes = [jload_sde(jcfg.sde[n]) for n in ("x", "adj")]
    key = jax.random.PRNGKey(7)
    jloss = jget_sde_loss_fn(*jsdes, *jms, reduce_mean=jcfg.train.reduce_mean, eps=eps)
    loss = get_sde_loss_fn(*[load_sde(cfg.sde[n]) for n in ("x", "adj")],
                           reduce_mean=cfg.train.reduce_mean, eps=eps)

    # f32: the losses on the JAX draws
    ms = [load_jax_params(load_model(d), p) for d, p in zip(defs, ps)]
    xs, adjs32 = jnp.asarray(x), jnp.asarray(adj)
    with torch.no_grad():
        got = loss.losses(*ms, _t(x), _t(adj), *_draws(key, xs, adjs32, jsdes[1], eps))
    np.testing.assert_allclose([v.item() for v in got],
                               np.asarray(jax.jit(jloss)(*ps, xs, adjs32, key)), rtol=1e-5)

    # float64: the loss and every parameter's gradient
    with jax.enable_x64(True):
        ps64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), ps)
        x64, adj64 = jnp.asarray(x, jnp.float64), jnp.asarray(adj, jnp.float64)
        want, jgrads = jax.jit(jax.value_and_grad(lambda p: sum(jloss(*p, x64, adj64, key))))(
            ps64)
        draws = _x64_draws(key, x64, adj64, jsdes[1], eps)
    assert all(d.dtype == torch.float64 for d in draws)
    ms = [load_jax_params(load_model(d), p).double() for d, p in zip(defs, ps)]
    total = sum(loss.losses(*ms, torch.from_numpy(x).double(), torch.from_numpy(adj).double(),
                            *draws))
    np.testing.assert_allclose(total.item(), float(want), rtol=1e-12)
    total.backward()
    for m, g in zip(ms, jgrads):
        ref = state_dict_from_jax(m, g)
        for name, p in m.named_parameters():
            got = p.grad.numpy() if p.grad is not None else np.zeros(p.shape)
            assert grad_ok(got, np.asarray(ref[name], np.float64), 1e-9), (
                name, np.abs(got - ref[name]).max(), np.abs(ref[name]).max())
