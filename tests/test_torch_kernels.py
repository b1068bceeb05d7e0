"""The port's kernel modules against the JAX Pallas kernels and modules.

On the CPU each wrapper of ccsd_tpu_torch.kernels takes its plain PyTorch
version; the JAX Pallas kernels run in interpret mode (as
tests/ops/test_pallas_kernels.py runs them).  Inputs come from a numpy seed.
Tolerance: rtol = atol = 1e-5 in f32, as in test_pallas_kernels.py:36 (the
two sides sum in different orders; nothing else differs).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ccsd_tpu.models.attention import Attention as JAttention
from ccsd_tpu.models.gcn import DenseGCNConv as JDenseGCNConv
from ccsd_tpu.ops.pallas.gcn import gcn_aggregate_pallas
from ccsd_tpu.ops.pallas.gmh_attention import gmh_attention_pallas

from ccsd_tpu_torch.kernels import LAUNCHES
from ccsd_tpu_torch.kernels.gcn import gcn_aggregate, gcn_aggregate_plain, gcn_norm
from ccsd_tpu_torch.kernels.gmh_attention import (
    gmh_attention,
    gmh_attention_plain,
    head_split,
)

TOL = dict(rtol=1e-5, atol=1e-5)


def _graph(B, N, Fi, C=None, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, N, Fi)).astype(np.float32)
    shape = (B, N, N) if C is None else (B, C, N, N)
    adj = np.triu((rng.random(shape) > 0.7).astype(np.float32), 1)
    return x, adj + np.swapaxes(adj, -1, -2)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


# (B, N, F_in, F_out): test_pallas_kernels.py shapes + community_small
# layers + grid's first layer (N = 361) at B = 1
GCN_SHAPES = [(3, 12, 5, 8), (2, 40, 8, 16), (4, 20, 11, 32), (4, 20, 32, 32),
              (1, 361, 5, 32)]


@pytest.mark.parametrize("shape", GCN_SHAPES)
@pytest.mark.parametrize("improved", [False, True])
def test_gcn_plain_matches_pallas_and_module(shape, improved):
    B, N, Fi, Fo = shape
    x, adj = _graph(B, N, Fi)
    conv = JDenseGCNConv(Fi, Fo, improved=improved)
    p = conv.init(jax.random.PRNGKey(1))
    p["bias"] = jnp.asarray(np.random.default_rng(2).standard_normal(Fo), jnp.float32)
    ref = np.asarray(conv.apply(p, jnp.asarray(x), jnp.asarray(adj)))
    pallas = np.asarray(gcn_aggregate_pallas(jnp.asarray(x), jnp.asarray(adj),
                                             p["weight"], p["bias"],
                                             improved=improved))
    loop = 2.0 if improved else 1.0
    out = gcn_aggregate_plain(_t(x), _t(adj), _t(p["weight"]), _t(p["bias"]), loop)
    np.testing.assert_allclose(out.numpy(), pallas, **TOL)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_gcn_without_loop_keeps_diagonal():
    """add_loop=False follows gcn_norm: the given diagonal stays."""
    x, adj = _graph(3, 9, 4, seed=5)
    adj[:, np.arange(9), np.arange(9)] = 0.5
    conv = JDenseGCNConv(4, 6)
    p = conv.init(jax.random.PRNGKey(3))
    ref = conv.apply(p, jnp.asarray(x), jnp.asarray(adj), add_loop=False)
    out = gcn_aggregate(_t(x), _t(adj), _t(p["weight"]), _t(p["bias"]),
                        add_loop=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_gcn_wrapper_routes_cpu_to_plain_without_counting():
    x, adj = _graph(2, 7, 3)
    w = _t(np.random.default_rng(0).standard_normal((3, 5)))
    before = dict(LAUNCHES)
    out = gcn_aggregate(_t(x), _t(adj), w)
    assert LAUNCHES == before  # the count is of kernel launches only
    np.testing.assert_array_equal(
        out.numpy(), gcn_aggregate_plain(_t(x), _t(adj), w).numpy())


def test_gcn_norm_matches_jax():
    from ccsd_tpu.models.gcn import gcn_norm as jgcn_norm

    _, adj = _graph(2, 11, 1, C=3, seed=4)
    for add_loop in (True, False):
        ref = jgcn_norm(jnp.asarray(adj), add_loop=add_loop)
        np.testing.assert_allclose(gcn_norm(_t(adj), add_loop).numpy(),
                                   np.asarray(ref), **TOL)


def _jax_attention_params(Fi, A, O, H, C, seed):
    att = JAttention(Fi, A, O, num_heads=H, conv="GCN")
    keys = jax.random.split(jax.random.PRNGKey(seed), C)
    ps = [att.init(k) for k in keys]
    rng = np.random.default_rng(seed)
    for p in ps:  # non-zero biases, so the kernel's bias path is exercised
        for m in ("q", "k", "v"):
            p[m]["bias"] = jnp.asarray(
                rng.standard_normal(p[m]["bias"].shape) * 0.1, jnp.float32)
    return att, ps


def _stack(ps, m, leaf):
    return torch.stack([_t(p[m][leaf]) for p in ps])


# (B, N, F_in, attn, F_out, H, C): test_pallas_kernels.py shapes, then the
# community_small AttentionLayers at B = 4 (first layer C=2 on F=11, the
# others C=8 on nhid=32)
GMH_SHAPES = [
    (2, 14, 6, 8, 8, 2, 1),
    (2, 14, 6, 8, 8, 4, 1),
    (4, 20, 11, 32, 32, 4, 2),
    (4, 20, 32, 32, 32, 4, 8),
]


@pytest.mark.parametrize("shape", GMH_SHAPES)
def test_gmh_plain_matches_pallas_and_module(shape):
    B, N, Fi, A, O, H, C = shape
    x, adj = _graph(B, N, Fi, C=C, seed=3)
    att, ps = _jax_attention_params(Fi, A, O, H, C, seed=4)
    v, a = gmh_attention_plain(
        _t(x), _t(adj), _stack(ps, "q", "weight"), _stack(ps, "q", "bias"),
        _stack(ps, "k", "weight"), _stack(ps, "k", "bias"),
        _stack(ps, "v", "weight"), _stack(ps, "v", "bias"), H, O)
    assert v.shape == (B, N, C * O) and a.shape == (B, N, N, C)
    for c, p in enumerate(ps):
        xj, aj = jnp.asarray(x), jnp.asarray(adj[:, c])
        V0, A0 = att.apply(p, xj, aj, None)
        V1, A1 = gmh_attention_pallas(
            xj, aj, p["q"]["weight"], p["q"]["bias"], p["k"]["weight"],
            p["k"]["bias"], p["v"]["weight"], p["v"]["bias"], H, O)
        for ref in ((V0, A0), (V1, A1)):
            np.testing.assert_allclose(v[..., c * O:(c + 1) * O].numpy(),
                                       np.asarray(ref[0]), **TOL)
            np.testing.assert_allclose(a[..., c].numpy(), np.asarray(ref[1]), **TOL)


def test_gmh_wrapper_routes_cpu_to_plain():
    B, N, Fi, A, O, H, C = 2, 9, 5, 8, 6, 4, 3
    x, adj = _graph(B, N, Fi, C=C, seed=7)
    rng = np.random.default_rng(8)
    w = [_t(rng.standard_normal(s)) for s in
         [(C, Fi, A), (C, A), (C, Fi, A), (C, A), (C, Fi, O), (C, O)]]
    before = dict(LAUNCHES)
    out = gmh_attention(_t(x), _t(adj), *w, H, O)
    assert LAUNCHES == before
    ref = gmh_attention_plain(_t(x), _t(adj), *w, H, O)
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o.numpy(), r.numpy())


@pytest.mark.parametrize("attn_dim,heads,expect", [(32, 4, (4, 8)), (8, 3, (4, 2))])
def test_head_split_matches_torch_split(attn_dim, heads, expect):
    assert head_split(attn_dim, heads) == expect
    with pytest.raises(ValueError):
        head_split(10, 3)
