"""The fused AttentionLayer's kernel modules against the Pallas probe
kernels they replace (their kernels against their plain versions on the
card: tests/test_torch_package.py, which imports no JAX).

The probes (tools/probe_pallas_agg.py, tools/pallas_scores_probe.py) are
imported by path and run in interpret mode on the CPU: each module's ``pl``
is replaced by a namespace whose ``pallas_call`` passes ``interpret=True``,
and its shape constants are set small.  Nothing under tools/ is edited.
The probes keep the batch last, (C, N, N, B); the port keeps it first, so
the tests transpose.  Inputs come from a numpy seed.

Tolerances:
* f32: rtol = atol = 1e-5, as in tests/test_torch_kernels.py (the two
  sides sum in different orders; nothing else differs).
* bf16 scores against the JAX model path (XLA rounds Q, K and each head's
  sum to bf16 once, as the port does): products of bf16 values are exact in
  f32, so the two sides differ only where their f32 sums round to
  different bf16 neighbours, by one bf16 ulp of the sum.  Through tanh
  (slope <= 1), the 1/sqrt(O) scale and the head mean that is at most
  ulp(max |s|) / sqrt(O), plus the f32 tolerance.
* bf16 scores against the bf16 probes, which round every product and every
  partial sum to bf16: per head the probe's sum is off the exact one by at
  most ds ulps of T = sum_d |q_d k_d| (ds products and ds - 1 adds, half an
  ulp each), the port's by half an ulp of T; the map bound is the head mean
  of (ds + 1/2) ulp(T_h) / sqrt(O), element by element, plus 1e-5.
"""

import functools
import importlib.util
import math
import os
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental import pallas as jpl

from ccsd_tpu_torch.kernels import LAUNCHES
from ccsd_tpu_torch.kernels.channel_agg import channel_agg, channel_agg_plain
from ccsd_tpu_torch.kernels.gmh_scores import (
    gmh_scores,
    gmh_scores_plain,
    head_scores,
    round_bf16,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)
INTERPRET = types.SimpleNamespace(
    pallas_call=functools.partial(jpl.pallas_call, interpret=True),
    BlockSpec=jpl.BlockSpec, ds=jpl.ds)


def _probe(name, **consts):
    """A fresh import of tools/<name>.py in interpret mode at small shapes."""
    spec = importlib.util.spec_from_file_location(
        f"_probe_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.pl = INTERPRET
    for k, v in consts.items():
        setattr(mod, k, v)
    return mod


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def bf16_ulp(v):
    """The spacing of bf16 numbers at |v| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(v), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


# (C, N, F, B): a small case, and community_small's first layer at B = 2
AGG_SHAPES = [(3, 6, 5, 4), (2, 20, 11, 2)]
# grid's first layer (N = 361) at B = 1: the probes unroll N, so the JAX
# side there is gcn_norm followed by an einsum
GRID_AGG_SHAPE = (2, 361, 5, 1)


def _agg_adj(B, C, N, layout, seed=0):
    """A symmetric (B, C, N, N) adjacency as numpy and as a tensor, the
    tensor contiguous or the channels-last view a later fused layer
    receives."""
    rng = np.random.default_rng(seed)
    adj = np.triu(rng.random((B, C, N, N)).astype(np.float32), 1)
    adj = adj + np.swapaxes(adj, -1, -2)
    t = _t(adj)
    if layout == "channels-last":
        t = t.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)
        assert not t.is_contiguous()
    return adj, t


@pytest.mark.parametrize("layout", ["contiguous", "channels-last"])
@pytest.mark.parametrize("shape", AGG_SHAPES + [GRID_AGG_SHAPE])
@pytest.mark.parametrize("probe", ["agg_pallas", "agg_pallas_2d"])
def test_channel_agg_plain_matches_probe(shape, probe, layout):
    """channel_agg_plain(adj, x) against ccsd_tpu.models.gcn.gcn_norm
    followed by the probe in interpret mode (an einsum at N = 361)."""
    from ccsd_tpu.models.gcn import gcn_norm as jgcn_norm

    C, N, F, B = shape
    adj, adj_t = _agg_adj(B, C, N, layout)
    x = np.random.default_rng(1).standard_normal((B, N, F)).astype(np.float32)
    norm = np.asarray(jgcn_norm(jnp.asarray(adj)))  # (B, C, N, N)
    if shape == GRID_AGG_SHAPE:
        ref = np.einsum("bcnm,bmf->bcnf", norm, x)
    else:
        mod = _probe("probe_pallas_agg", C=C, N=N, F=F, B=B)
        norm_l = np.ascontiguousarray(norm.transpose(1, 2, 3, 0))  # (C, N, N, B)
        x_l = np.ascontiguousarray(x.transpose(1, 2, 0))           # (N, F, B)
        if probe == "agg_pallas":
            ref = np.asarray(mod.agg_pallas(norm_l, x_l))
        else:
            ref = np.asarray(mod.agg_pallas_2d(norm_l.reshape(C * N, N, B), x_l))
            ref = ref.reshape(C, N, F, B)
        ref = ref.transpose(3, 0, 1, 2)
    out = channel_agg_plain(adj_t, _t(x))
    assert out.shape == (B, C, N, F)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    if layout == "contiguous":  # the probes' folded (B, C*N, N) form
        folded = channel_agg_plain(adj_t.reshape(B, C * N, N), _t(x))
        assert folded.shape == (B, C * N, F)
        np.testing.assert_allclose(folded.reshape(B, C, N, F).numpy(), ref, **TOL)


@pytest.mark.parametrize("layout", ["contiguous", "channels-last"])
@pytest.mark.parametrize("shape", AGG_SHAPES)
def test_channel_agg_plain_bf16_matches_jax_dot_bf16(shape, layout):
    """bf16=True against the JAX layer's agg_impl="dot_bf16" contraction
    (ccsd_tpu/models/attention.py:230-234) under jit, after gcn_norm: both
    round norm and x to bf16 and sum exact products in f32; the JAX einsum
    returns bf16, so the port's output is rounded as the layer rounds it.
    The two f32 sums may round to neighbouring bf16 values: one bf16 ulp of
    the output, plus the f32 tolerance."""
    from ccsd_tpu.models.gcn import gcn_norm as jgcn_norm

    C, N, F, B = shape
    adj, adj_t = _agg_adj(B, C, N, layout, seed=2)
    x = np.random.default_rng(3).standard_normal((B, N, F)).astype(np.float32)

    @jax.jit
    def ref_fn(a, xx):
        norm = jgcn_norm(a)
        out = jnp.einsum("bcnm,bmf->bcnf", norm.astype(jnp.bfloat16), xx.astype(jnp.bfloat16))
        return out.astype(jnp.float32)

    ref = np.asarray(ref_fn(adj, x))
    out = round_bf16(channel_agg_plain(adj_t, _t(x), bf16=True)).numpy()
    np.testing.assert_array_less(np.abs(out - ref), bf16_ulp(ref) + 1e-5 * (1 + np.abs(ref)))
    # and the bf16 rounding is what the comparison sees
    f32 = channel_agg_plain(adj_t, _t(x)).numpy()
    assert np.abs(f32 - ref).max() > 1e-4


def _qk(B, C, N, A, scale=0.5, seed=1):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, C, N, A)) * scale).astype(np.float32)
    k = (rng.standard_normal((B, C, N, A)) * scale).astype(np.float32)
    return q, k


def _probe_bound(q, k, H, O):
    """Elementwise |port bf16 - probe bf16| bound (module docstring)."""
    B, C, N, A = q.shape
    ds = A // H
    qb = q.astype(jnp.bfloat16).astype(np.float32).reshape(B, C, N, H, ds)
    kb = k.astype(jnp.bfloat16).astype(np.float32).reshape(B, C, N, H, ds)
    T = np.einsum("bcnhd,bcmhd->bchnm", np.abs(qb), np.abs(kb))
    return ((ds + 0.5) * bf16_ulp(T)).mean(axis=2) / math.sqrt(O) + 1e-5


# (B, C, N, A, H, O)
SCORE_SHAPES = [(4, 2, 10, 16, 4, 32), (2, 3, 7, 8, 2, 6)]


@pytest.mark.parametrize("shape", SCORE_SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("probe", ["make_pallas", "make_pallas_reg"])
def test_head_scores_plain_matches_probe(shape, dtype, probe):
    B, C, N, A, H, O = shape
    mod = _probe("pallas_scores_probe", B=B, C=C, N=N, A=A, H=H, O=O,
                 DS=A // H, INV=1.0 / math.sqrt(O))
    q, k = _qk(B, C, N, A)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    make = getattr(mod, probe)
    fn = make(jdt) if probe == "make_pallas" else make(jdt, N // 2 if N % 2 == 0 else N)
    ql, kl = (np.ascontiguousarray(a.transpose(1, 3, 2, 0)) for a in (q, k))  # (C, A, N, B)
    ref = np.asarray(fn(ql, kl)).transpose(3, 0, 1, 2)  # -> (B, C, N, N)
    out = head_scores(_t(q), _t(k), H, O, bf16=dtype == "bf16").numpy()
    if dtype == "f32":
        np.testing.assert_allclose(out, ref, **TOL)
    else:
        bound = _probe_bound(q, k, H, O)
        assert (np.abs(out - ref) <= bound).all(), np.abs(out - ref).max()


@pytest.mark.parametrize("shape", SCORE_SHAPES)
def test_head_scores_bf16_matches_jax_model_path(shape):
    """The rounding points of scores_impl="mulreduce_h_bf16"
    (ccsd_tpu/models/attention.py:305-318) under jit, at the map level."""
    B, C, N, A, H, O = shape
    ds = A // H
    q, k = _qk(B, C, N, A, scale=1.0, seed=2)

    @jax.jit
    def ref_fn(Q, K):
        Qh = Q.reshape(B, C, N, H, ds).astype(jnp.bfloat16)
        Kh = K.reshape(B, C, N, H, ds).astype(jnp.bfloat16)
        acc = None
        for h in range(H):
            s = (Qh[:, :, :, None, h, :] * Kh[:, :, None, :, h, :]).sum(-1)
            t = jnp.tanh(s.astype(jnp.float32) / math.sqrt(O))
            acc = t if acc is None else acc + t
        return acc / H

    ref = np.asarray(ref_fn(q, k))
    out = head_scores(_t(q), _t(k), H, O, bf16=True).numpy()
    s_max = np.abs(np.einsum("bcnhd,bcmhd->bchnm", q.reshape(B, C, N, H, ds),
                             k.reshape(B, C, N, H, ds))).max()
    tol = bf16_ulp(s_max) / math.sqrt(O) + 1e-5
    assert np.abs(out - ref).max() <= tol
    # and bf16 rounding moves the map here by far more than f32 rounding
    f32 = head_scores(_t(q), _t(k), H, O).numpy()
    assert np.abs(f32 - ref).max() > 1e-4


def test_gmh_scores_plain_is_the_symmetrised_channels_last_map():
    q, k = _qk(2, 3, 6, 8)
    att = head_scores(_t(q), _t(k), 2, 6)
    out = gmh_scores_plain(_t(q), _t(k), 2, 6)
    assert out.shape == (2, 6, 6, 3) and out.is_contiguous()
    np.testing.assert_array_equal(
        out.numpy(), ((att + att.transpose(-1, -2)) / 2).permute(0, 2, 3, 1).numpy())


def test_wrappers_route_cpu_to_plain_without_counting():
    rng = np.random.default_rng(3)
    norm, x = _t(rng.random((2, 3, 5, 5))), _t(rng.standard_normal((2, 5, 4)))
    q, k = (_t(a) for a in _qk(2, 3, 5, 8))
    before = dict(LAUNCHES)
    agg, sc = channel_agg(norm, x), gmh_scores(q, k, 2, 4, bf16=True)
    assert LAUNCHES == before  # the count is of kernel launches only
    np.testing.assert_array_equal(agg.numpy(), channel_agg_plain(norm, x).numpy())
    np.testing.assert_array_equal(sc.numpy(),
                                  gmh_scores_plain(q, k, 2, 4, bf16=True).numpy())
