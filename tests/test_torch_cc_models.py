"""The port's Hodge layers and CC score networks against the JAX package's,
on the CPU, with the JAX parameters carried across by
``ccsd_tpu_torch.utils.from_jax``.

Sizes: N = 8 nodes, cells of 3 (E = 28, K = 56), B = 4 with ragged flags;
ScoreNetworkA_CC with 2 AttentionLayers (channels 2 -> 4 -> 2, adim 8, 2
heads, F = 5 features) and one HodgeAdjAttentionLayer (c_hid_h = c_final_h
= 2, adim_h 4, 2 heads, HCN), ScoreNetworkF with cnum 2 and 2 layers.
Every parameter is nudged off the JAX init (which zeroes biases), so each is
compared.  Tolerances: layers and whole networks rtol = atol = 1e-5, as
the graph layers: at K = 56 the f32 sums stay close (measured: the
networks' largest distance 1.7e-6 on outputs up to 3.7, i.e. at most 5.2e-7
of the largest output).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ccsd_tpu.models import hodge_nn as jhnn
from ccsd_tpu.models.registry import load_model as jload_model
from ccsd_tpu.models.registry import load_model_params as jload_model_params
from ccsd_tpu.models.registry import with_fused as jwith_fused
from ccsd_tpu.ops import cells as jcells
from ccsd_tpu.utils.config import get_config as jget_config

from ccsd_tpu_torch.models import hodge_nn
from ccsd_tpu_torch.models.registry import load_model, load_model_params, with_fused
from ccsd_tpu_torch.ops import cells
from ccsd_tpu_torch.utils.config import get_config
from ccsd_tpu_torch.utils.from_jax import load_jax_params

B, N, F, D = 4, 8, 5, 3
SPEC, JSPEC = cells.get_spec(N, D, D), jcells.get_spec(N, D, D)
E, K = SPEC.num_edges, SPEC.num_cells
TOL = dict(rtol=1e-5, atol=1e-5)
SMALL = {"depth": 2, "nhid": 8, "num_layers": 2, "c_init": 2, "c_hid": 4, "c_final": 2,
         "adim": 8, "num_heads": 2, "nhid_h": 4, "num_layers_h": 1, "num_linears_h": 1,
         "c_hid_h": 2, "c_final_h": 2, "adim_h": 4, "num_heads_h": 2, "cnum": 2,
         "num_layers_mlp": 2}


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _perturb(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: a + jnp.asarray(rng.standard_normal(a.shape) * 0.1, a.dtype), tree)


def small_cc_configs(num_layers_h=1):
    """(JAX config, port config) of community_small_CC cut to SMALL widths."""
    out = []
    for get in (jget_config, get_config):
        c = get("community_small_CC", 0)
        c.data.max_node_num, c.data.max_feat_num = N, F
        for k, v in SMALL.items():
            c.model[k] = v
        c.model.num_layers_h = num_layers_h
        out.append(c)
    return out


def cc_inputs(seed=0):
    """x, a 0/1 adjacency and a 0/1 incidence (its edges inside its cells,
    plus noise) of graphs of 8, 6, 5 and 7 nodes, and their flags."""
    rng = np.random.default_rng(seed)
    adj = np.triu((rng.random((B, N, N)) < 0.5).astype(np.float32), 1)
    adj = adj + adj.transpose(0, 2, 1)
    for b, n in enumerate((8, 6, 5, 7)):
        adj[b, n:] = adj[b, :, n:] = 0
        adj[b, 0, 1:n] = adj[b, 1:n, 0] = 1
    flags = (adj.sum(-1) > 0).astype(np.float32)
    x = rng.standard_normal((B, N, F)).astype(np.float32) * flags[..., None]
    inside = JSPEC.edge_in_cell[None] * adj[:, JSPEC.edge_u, JSPEC.edge_v][..., None]
    rank2 = ((inside * (rng.random((B, E, K)) < 0.3)) > 0).astype(np.float32)
    rank2 = rank2 + rng.standard_normal((B, E, K)).astype(np.float32) * 0.05
    return x, adj, rank2, flags


def hodge_in(seed=1, C=None):
    rng = np.random.default_rng(seed)
    shape = (B, E, E) if C is None else (B, C, E, E)
    h = rng.random(shape).astype(np.float32)
    return (h + np.swapaxes(h, -1, -2)) / 2


def test_dense_hcn_conv_matches_jax():
    _, _, r2, flags = cc_inputs()
    jm = jhnn.DenseHCNConv(K, 4)
    p = _perturb(jm.init(jax.random.PRNGKey(0)), 0)
    pm = load_jax_params(hodge_nn.DenseHCNConv(K, 4), p)
    h = hodge_in()
    h[0] *= 0.1  # rows summing below 1: the clip at 1 (no self-loop, no gcn_norm)
    mask = flags[:, JSPEC.edge_u] * flags[:, JSPEC.edge_v]
    for m in (None, mask):
        want = jm.apply(p, jnp.asarray(h), jnp.asarray(r2),
                        None if m is None else jnp.asarray(m))
        got = pm(_t(h), _t(r2), None if m is None else _t(m))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("heads", [1, 2])
def test_hodge_attention_matches_jax(heads):
    _, _, r2, flags = cc_inputs()
    jm = jhnn.HodgeAttention(K, 4, K, num_heads=heads)
    p = _perturb(jm.init(jax.random.PRNGKey(1)), 1)
    pm = load_jax_params(hodge_nn.HodgeAttention(K, 4, K, heads), p)
    h = hodge_in(2)
    jv, ja = jm.apply(p, jnp.asarray(h), jnp.asarray(r2), jnp.asarray(flags))
    v, a = pm(_t(h), _t(r2))
    np.testing.assert_allclose(v.detach().numpy(), np.asarray(jv), **TOL)
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(ja), **TOL)
    assert set(dict(pm.named_parameters())) == {"ccnn_q.weight", "ccnn_q.bias",
                                                "ccnn_k.weight", "ccnn_k.bias"}


@pytest.mark.parametrize("cin,cout", [(2, 2), (2, 3)])
def test_hodge_adj_attention_layer_matches_jax(cin, cout):
    _, _, r2, flags = cc_inputs(2)
    jm = jhnn.HodgeAdjAttentionLayer(1, cin, 4, cout, JSPEC, num_heads=2)
    p = _perturb(jm.init(jax.random.PRNGKey(2)), 2)
    pm = load_jax_params(hodge_nn.HodgeAdjAttentionLayer(1, cin, 4, cout, SPEC, 2), p)
    h = hodge_in(3, C=cin)
    jh, jr = jm.apply(p, jnp.asarray(h), jnp.asarray(r2), jnp.asarray(flags))
    ph, pr = pm(_t(h), _t(r2), _t(flags))
    np.testing.assert_allclose(ph.detach().numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(pr.detach().numpy(), np.asarray(jr), **TOL)
    assert ph.shape == (B, cout, E, E) and pr.shape == (B, E, K)


def test_hodge_network_layer_matches_jax():
    _, _, r2, flags = cc_inputs(3)
    rng = np.random.default_rng(3)
    r = np.stack([r2, r2 * 0.5 + rng.standard_normal(r2.shape).astype(np.float32)], 1)
    jm = jhnn.HodgeNetworkLayer(2, 2, 4, 3, JSPEC)
    p = _perturb(jm.init(jax.random.PRNGKey(3)), 3)
    pm = load_jax_params(hodge_nn.HodgeNetworkLayer(2, 2, 4, 3, SPEC), p)
    got = pm(_t(r), _t(flags)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(p, jnp.asarray(r), jnp.asarray(flags))),
                               **TOL)


def test_load_model_params_match_jax():
    jcfg, cfg = small_cc_configs()
    jdefs, defs = jload_model_params(jcfg, is_cc=True), load_model_params(cfg)
    assert len(defs) == 3
    for j, p in zip(jdefs, defs):
        assert dict(j) == dict(p)
    fused = with_fused(dict(zip(("x", "adj", "rank2"), defs)))
    jfused = jwith_fused(dict(zip(("x", "adj", "rank2"), jdefs)))
    assert fused["adj"] == jfused["adj"]  # fused, f32 scores, concat final layer
    assert "scores_impl" not in fused["adj"] and "final_impl" not in fused["adj"]
    assert fused["rank2"] == jfused["rank2"] and fused["rank2"]["fused"] is True
    assert load_model(fused["rank2"]).fused


def _networks(name, fused, num_layers_h=1, seed=0):
    jcfg, cfg = small_cc_configs(num_layers_h)
    i = ("x", "adj", "rank2").index(name)
    jdef, pdef = jload_model_params(jcfg, is_cc=True)[i], load_model_params(cfg)[i]
    if fused:
        jdef, pdef = dict(jdef, fused=True), dict(pdef, fused=True)
    jm = jload_model(jdef)
    p = _perturb(jm.init(jax.random.PRNGKey(seed)), seed)
    return jm, p, load_jax_params(load_model(pdef), p)


@pytest.mark.parametrize("name,fused,num_layers_h", [
    ("x", False, 1), ("adj", False, 1), ("adj", True, 1), ("adj", False, 2),
    ("adj", True, 2), ("rank2", False, 1), ("rank2", False, 2)])
def test_cc_networks_match_jax(name, fused, num_layers_h):
    x, adj, r2, flags = cc_inputs(4)
    jm, p, pm = _networks(name, fused, num_layers_h)
    want = np.asarray(jm.apply(p, jnp.asarray(x), jnp.asarray(adj), jnp.asarray(r2),
                               flags=jnp.asarray(flags)))
    got = pm(_t(x), _t(adj), rank2=_t(r2), flags=_t(flags)).detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)
    if name == "adj":  # zero diagonal, absent nodes' rows and columns zero
        assert not np.diagonal(got, axis1=1, axis2=2).any()
        assert not got[flags == 0].any()
    if name == "rank2":
        fl = flags[:, JSPEC.edge_u] * flags[:, JSPEC.edge_v]
        assert not got[fl == 0].any()
