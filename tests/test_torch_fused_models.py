"""The fused (channel-folded) AttentionLayer and ScoreNetworkA against the
JAX package's, on the CPU, with the same parameter trees and numpy inputs.

The JAX side runs under ``jax.jit``, as its samplers run it: XLA then
rounds a bf16 expression where the port's kernels do (Q, K and each head's
sum once), while eager op-by-op JAX rounds every product as well.

Tolerances:
* f32 lowerings: rtol = atol = 1e-5 per layer, 1e-4 per network, as in
  tests/test_torch_models.py.
* bf16 head scores: one bf16 ulp of the largest head sum |s|, through tanh
  (slope <= 1), 1/sqrt(O) and the head mean, bounds a map entry
  (tests/test_torch_fused_kernels.py); the adjacency output is that bound
  through the edge MLP (its weights' infinity norms; elu is 1-Lipschitz)
  and the symmetrisation (x 2).  The node output does not see the scores.
* whole networks with bf16 scores: rtol = 1e-4, atol = 1e-3.  Products
  of bf16 values are exact in f32, so the two sides round a head sum to
  different bf16 neighbours only where their f32 sums fall on either side
  of a rounding boundary: 0.04 to 0.4 % of a layer's map entries, each
  moved by at most one ulp(|s|) / sqrt(O) (the bound above; measured up
  to 1.6e-4 at N = 20), which the later layers carry to the output.
  Measured on the CPU over three weight seeds at this test's shapes: the
  port's fast network is 2.7e-5 to 1.3e-4 off JAX's; with community_small's
  N = 20 and perturbed weights up to 4.3e-3.  JAX's network with f32
  scores is 2.1e-3 to 1.4e-2 off the port's fast one at this test's
  shapes (1.4e-2 at its seed), so the tolerance tells the roundings apart.
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ccsd_tpu.models import attention as jatt
from ccsd_tpu.models.registry import FUSED_CAPABLE as jFUSED_CAPABLE
from ccsd_tpu.models.registry import load_model as jload_model
from ccsd_tpu.models.registry import load_model_params as jload_model_params
from ccsd_tpu.models.registry import with_fused as jwith_fused
from ccsd_tpu.utils.config import get_config as jget_config
from ccsd_tpu.utils.torch_convert import convert

import ccsd_tpu_torch.models.attention as patt
from ccsd_tpu_torch.models.attention import SCORES_BF16, AttentionLayer
from ccsd_tpu_torch.models.registry import (
    FUSED_CAPABLE,
    load_model,
    load_model_params,
    with_fused,
)
from ccsd_tpu_torch.utils.config import get_config
from ccsd_tpu_torch.utils.from_jax import load_jax_params

LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
NET_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_NET_TOL = dict(rtol=1e-4, atol=1e-3)
B, N = 3, 12


def _inputs(F, C=None, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, N, F)).astype(np.float32)
    shape = (B, N, N) if C is None else (B, C, N, N)
    adj = np.triu(rng.random(shape).astype(np.float32), 1)
    adj = adj + np.swapaxes(adj, -1, -2)
    flags = np.ones((B, N), np.float32)
    flags[:, 9:] = 0.0
    flags[1, 6:] = 0.0
    return x, adj, flags


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _perturb_biases(tree, seed=1):
    """JAX init zeroes biases; give them values so they are compared too."""
    rng = np.random.default_rng(seed)

    def go(t):
        if isinstance(t, dict):
            return {k: (jnp.asarray(rng.standard_normal(v.shape) * 0.1, jnp.float32)
                        if k in ("b", "bias") else go(v)) for k, v in t.items()}
        if isinstance(t, list):
            return [go(v) for v in t]
        return t

    return go(tree)


def bf16_ulp(v):
    """The spacing of bf16 numbers at |v| (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(max(abs(v), 1e-30))) - 7)


# (num_linears, conv_in, attn, conv_out, C_in, C_out): a first layer on raw
# features with three channels in, narrow widths
DIMS = (2, 11, 16, 16, 3, 4)
HEADS = 4


@pytest.mark.parametrize("agg_impl", ["mulreduce", "dot", "dot_bf16"])
@pytest.mark.parametrize("scores_impl", sorted(SCORES_BF16))
@pytest.mark.parametrize("conv", ["GCN", "MLP"])
def test_fused_attention_layer_matches_jax(monkeypatch, conv, scores_impl, agg_impl):
    kw = dict(num_heads=HEADS, conv=conv, fused=True, scores_impl=scores_impl,
              agg_impl=agg_impl)
    jm = jatt.AttentionLayer(*DIMS, **kw)
    p = _perturb_biases(jm.init(jax.random.PRNGKey(3)))
    m = load_jax_params(AttentionLayer(*DIMS, **kw), p)
    x, adj, flags = _inputs(DIMS[1], C=DIMS[4], seed=3)
    h0, a0 = jax.jit(jm.apply)(p, jnp.asarray(x), jnp.asarray(adj), jnp.asarray(flags))

    seen = []
    real = patt.gmh_scores
    monkeypatch.setattr(patt, "gmh_scores",
                        lambda q, k, *a, **k_: seen.append((q, k)) or real(q, k, *a, **k_))
    with torch.no_grad():
        h1, a1 = m(_t(x), _t(adj), _t(flags))
    assert len(seen) == 1
    np.testing.assert_allclose(h1.numpy(), np.asarray(h0), **LAYER_TOL)
    if not SCORES_BF16[scores_impl]:
        np.testing.assert_allclose(a1.numpy(), np.asarray(a0), **LAYER_TOL)
        return
    q, k = seen[0]
    ds = q.shape[-1] // HEADS
    s = torch.einsum("bcnhd,bcmhd->bchnm", q.reshape(*q.shape[:3], HEADS, ds),
                     k.reshape(*k.shape[:3], HEADS, ds))
    map_tol = bf16_ulp(s.abs().max().item()) / math.sqrt(DIMS[3])
    gain = math.prod(lin.weight.abs().sum(1).max().item() for lin in m.mlp.linears)
    tol = 2 * gain * map_tol + 1e-5
    assert np.abs(a1.numpy() - np.asarray(a0)).max() <= tol


def _community_defs():
    """(JAX, port) ScoreNetworkA definitions of community_small."""
    jdef = jload_model_params(jget_config("community_small", 0))[1]
    pdef = load_model_params(get_config("community_small", 0))[1]
    assert jdef == pdef
    return jdef


@pytest.mark.parametrize("fast", [False, True], ids=["fused_f32", "fused_fast"])
def test_fused_score_network_a_matches_jax(fast):
    """community_small's ScoreNetworkA at B = 3, N = 12 with the defs the
    JAX samplers build (fused, and with fast: bf16 scores and blocksum)."""
    jdef = {**_community_defs(), "max_node_num": N}
    jdef = jwith_fused({"adj": jdef}, True, fast=fast)["adj"]
    assert jdef["fused"] and (jdef.get("final_impl") == "blocksum") == fast
    jm = jload_model(jdef)
    p = _perturb_biases(jm.init(jax.random.PRNGKey(6)))
    m = load_jax_params(load_model(jdef), p)
    assert m.layers[0].fused and m.final_impl == ("blocksum" if fast else "concat")
    x, adj, flags = _inputs(11, seed=6)
    ref = jax.jit(lambda p, x, a, f: jm.apply(p, x, a, flags=f))(
        p, jnp.asarray(x), jnp.asarray(adj), jnp.asarray(flags))
    with torch.no_grad():
        out = m(_t(x), _t(adj), _t(flags))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               **(BF16_NET_TOL if fast else NET_TOL))


def test_blocksum_final_equals_concat_final():
    """final_impl changes how the first final layer is applied, not what
    it computes: the same weights give the same score."""
    pdef = {**_community_defs(), "max_node_num": N, "fused": True}
    g = torch.Generator().manual_seed(4)
    a = load_model(pdef, generator=g)
    b = load_model({**pdef, "final_impl": "blocksum"})
    b.load_state_dict(a.state_dict())
    x, adj, flags = _inputs(11, seed=4)
    with torch.no_grad():
        np.testing.assert_allclose(b(_t(x), _t(adj), _t(flags)).numpy(),
                                   a(_t(x), _t(adj), _t(flags)).numpy(), **LAYER_TOL)


@pytest.mark.parametrize("enable,fast", [(True, True), (True, False), (False, True)])
def test_with_fused_defs_match_jax(enable, fast):
    jcfg, cfg = jget_config("community_small", 0), get_config("community_small", 0)
    jdefs = dict(zip(("x", "adj"), jload_model_params(jcfg)))
    pdefs = dict(zip(("x", "adj"), load_model_params(cfg)))
    assert with_fused(pdefs, enable, fast) == jwith_fused(jdefs, enable, fast)
    # setdefault: a definition that names its lowering keeps it
    named = {"adj": {**pdefs["adj"], "scores_impl": "mulreduce"}}
    assert with_fused(named, enable, fast) == jwith_fused(named, enable, fast)
    # ScoreNetworkA_CC joined with CC mode, ScoreNetworkF's slab-unrolled
    # form with the two-stage model, ScoreNetworkA_Base_CC with the ablation
    # network, ScoreNetworkX_GMH last: the JAX set
    assert FUSED_CAPABLE == jFUSED_CAPABLE == {
        "ScoreNetworkX_GMH", "ScoreNetworkA", "ScoreNetworkA_CC", "ScoreNetworkA_Base_CC",
        "ScoreNetworkF"}


def test_model_fused_in_a_training_config_matches_jax():
    jcfg, cfg = jget_config("community_small", 0), get_config("community_small", 0)
    jcfg.model.fused = True
    cfg.model.fused = True
    assert load_model_params(cfg) == jload_model_params(jcfg)


def test_fused_state_dict_converts_back_to_the_jax_tree():
    """The fused layer has the unfused layer's parameters under the same
    names, so a JAX tree loads into it and converts back unchanged."""
    jdef = jwith_fused({"adj": _community_defs()}, True)["adj"]
    jm = jload_model(jdef)
    p = _perturb_biases(jm.init(jax.random.PRNGKey(7)))
    m = load_jax_params(load_model(jdef), p)
    sd = {k: v.detach().numpy() for k, v in m.state_dict().items()}
    back = convert(jm, sd)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(p)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_unknown_lowering_raises():
    with pytest.raises(ValueError, match="lowering"):
        AttentionLayer(*DIMS, fused=True, scores_impl="pallas")
    with pytest.raises(ValueError, match="final_impl"):
        load_model({**_community_defs(), "final_impl": "sum"})
