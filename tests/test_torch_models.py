"""The port's modules against the JAX modules, on the CPU.

Each case initialises the JAX module, loads its parameter tree into the
port's module through ccsd_tpu_torch.utils.from_jax, and runs both on the
same numpy inputs.  Tolerances: single layers rtol = atol = 1e-5 (f32,
different summation order only); whole score networks rtol = atol = 1e-4,
because the small per-layer rounding differences pass through five
AttentionLayers (or three GCN layers) and the MLP heads.

The state-dict names are held to the reference's: converting the port's
``state_dict()`` with ccsd_tpu/utils/torch_convert.py must give back the JAX
tree exactly.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ccsd_tpu.models import attention as jatt
from ccsd_tpu.models import nn as jnn
from ccsd_tpu.models.gcn import DenseGCNConv as JDenseGCNConv
from ccsd_tpu.models.registry import load_model as jload_model
from ccsd_tpu.models.registry import load_model_params as jload_model_params
from ccsd_tpu.utils.config import get_config as jget_config
from ccsd_tpu.utils.torch_convert import convert

from ccsd_tpu_torch.models.attention import Attention, AttentionLayer
from ccsd_tpu_torch.models.gcn import DenseGCNConv
from ccsd_tpu_torch.models.nn import MLP
from ccsd_tpu_torch.models.registry import load_model, load_model_params
from ccsd_tpu_torch.utils.config import get_config
from ccsd_tpu_torch.utils.from_jax import load_jax_params

LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
NET_TOL = dict(rtol=1e-4, atol=1e-4)
B, N = 4, 20


def _inputs(F, C=None, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, N, F)).astype(np.float32)
    shape = (B, N, N) if C is None else (B, C, N, N)
    adj = np.triu(rng.random(shape).astype(np.float32), 1)
    adj = adj + np.swapaxes(adj, -1, -2)
    flags = np.ones((B, N), np.float32)
    flags[:, 15:] = 0.0
    flags[1, 10:] = 0.0
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


def _tree_equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _tree_equal(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _tree_equal(u, v)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_graph_masks_match_jax():
    from ccsd_tpu.ops import hodge as jhodge
    from ccsd_tpu.ops import masks as jmasks

    from ccsd_tpu_torch.ops import masks

    x, adj, flags = _inputs(5, seed=9)
    adj4 = np.stack([adj, adj * 0.5], axis=1)
    cases = [
        (masks.mask_x(_t(x), _t(flags)), jmasks.mask_x(x, flags)),
        (masks.mask_adjs(_t(adj), _t(flags)), jmasks.mask_adjs(adj, flags)),
        (masks.mask_adjs(_t(adj4), _t(flags)), jmasks.mask_adjs(adj4, flags)),
        (masks.node_flags(masks.mask_adjs(_t(adj), _t(flags))),
         jmasks.node_flags(jmasks.mask_adjs(adj, flags))),
        (masks.node_flags(_t(adj4) * _t(flags)[:, None, None, :]),
         jmasks.node_flags(adj4 * flags[:, None, None, :])),
        (masks.quantize(_t(adj)), jmasks.quantize(jnp.asarray(adj))),
        (masks.pow_tensor(_t(adj), 3), jmasks.pow_tensor(jnp.asarray(adj), 3)),
        (masks.default_mask(N), jhodge.default_mask(N)),
    ]
    for got, ref in cases:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **LAYER_TOL)

    # noise: another generator than JAX's, so held to its structure
    g = torch.Generator().manual_seed(0)
    z = masks.gen_noise(_t(adj), _t(flags), sym=True, generator=g)
    assert torch.equal(z, z.transpose(-1, -2)) and not z.diagonal(dim1=1, dim2=2).any()
    assert torch.equal(z, masks.mask_adjs(z, _t(flags))) and z.std() > 0.5
    zx = masks.gen_noise(_t(x), _t(flags), sym=False, generator=g)
    assert torch.equal(zx, masks.mask_x(zx, _t(flags))) and zx.std() > 0.5


@pytest.mark.parametrize("layers,act", [(1, "relu"), (2, "tanh"), (3, "elu")])
def test_mlp(layers, act):
    jm = jnn.MLP(layers, 7, 12, 5, act=act)
    p = _perturb_biases(jm.init(jax.random.PRNGKey(0)))
    m = load_jax_params(MLP(layers, 7, 12, 5, act=act), p)
    x = np.random.default_rng(3).standard_normal((B, N, 7)).astype(np.float32)
    np.testing.assert_allclose(m(_t(x)).detach().numpy(),
                               np.asarray(jm.apply(p, jnp.asarray(x))), **LAYER_TOL)


def test_dense_gcn_conv():
    jm = JDenseGCNConv(11, 32)
    p = _perturb_biases(jm.init(jax.random.PRNGKey(1)))
    m = load_jax_params(DenseGCNConv(11, 32), p)
    x, adj, flags = _inputs(11)
    ref = jm.apply(p, jnp.asarray(x), jnp.asarray(adj), mask=jnp.asarray(flags))
    out = m(_t(x), _t(adj), mask=_t(flags))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **LAYER_TOL)


@pytest.mark.parametrize("conv", ["GCN", "MLP"])
def test_attention(conv):
    jm = jatt.Attention(11, 32, 32, num_heads=4, conv=conv)
    p = _perturb_biases(jm.init(jax.random.PRNGKey(2)))
    m = load_jax_params(Attention(11, 32, 32, 4, conv), p)
    x, adj, flags = _inputs(11, seed=2)
    V0, A0 = jm.apply(p, jnp.asarray(x), jnp.asarray(adj), jnp.asarray(flags))
    with torch.no_grad():
        V1, A1 = m(_t(x), _t(adj), _t(flags))
    np.testing.assert_allclose(V1.numpy(), np.asarray(V0), **LAYER_TOL)
    np.testing.assert_allclose(A1.numpy(), np.asarray(A0), **LAYER_TOL)


# community_small's first, middle and last AttentionLayer shapes
# (num_linears, conv_in, attn, conv_out, C_in, C_out)
LAYER_SHAPES = [(2, 11, 32, 32, 2, 8), (2, 32, 32, 32, 8, 8), (2, 32, 32, 32, 8, 4)]


@pytest.mark.parametrize("dims", LAYER_SHAPES)
@pytest.mark.parametrize("grad", [False, True])
def test_attention_layer(dims, grad):
    """grad=True takes the uncached weight stacks of the autograd path."""
    jm = jatt.AttentionLayer(*dims, num_heads=4, conv="GCN")
    p = _perturb_biases(jm.init(jax.random.PRNGKey(3)))
    m = load_jax_params(AttentionLayer(*dims, num_heads=4, conv="GCN"), p)
    x, adj, flags = _inputs(dims[1], C=dims[4], seed=3)
    h0, a0 = jm.apply(p, jnp.asarray(x), jnp.asarray(adj), jnp.asarray(flags))
    with torch.set_grad_enabled(grad):
        h1, a1 = m(_t(x), _t(adj), _t(flags))
        h2, a2 = m(_t(x), _t(adj), _t(flags))  # second call: cached stacks
    for h, a in ((h1, a1), (h2, a2)):
        np.testing.assert_allclose(h.detach().numpy(), np.asarray(h0), **LAYER_TOL)
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(a0), **LAYER_TOL)


def test_attention_layer_restacks_after_weight_change():
    dims = LAYER_SHAPES[0]
    m = AttentionLayer(*dims, generator=torch.Generator().manual_seed(0))
    x, adj, flags = _inputs(dims[1], C=dims[4], seed=4)
    with torch.no_grad():
        before = m(_t(x), _t(adj), _t(flags))[1]
        m.attn[1].gnn_q.weight.mul_(2.0)
        after = m(_t(x), _t(adj), _t(flags))[1]
    assert not torch.allclose(before, after)


def _nets():
    jcfg = jget_config("community_small", 0)
    cfg = get_config("community_small", 0)
    return list(zip(jload_model_params(jcfg), load_model_params(cfg)))


@pytest.mark.parametrize("which", [0, 1], ids=["ScoreNetworkX", "ScoreNetworkA"])
def test_score_network(which):
    jdef, pdef = _nets()[which]
    jm = jload_model(jdef)
    p = _perturb_biases(jm.init(jax.random.PRNGKey(5 + which)))
    m = load_jax_params(load_model(pdef), p)
    x, adj, flags = _inputs(11, seed=5)
    ref = jm.apply(p, jnp.asarray(x), jnp.asarray(adj), flags=jnp.asarray(flags))
    with torch.no_grad():
        out = m(_t(x), _t(adj), _t(flags))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **NET_TOL)


@pytest.mark.parametrize("which", [0, 1], ids=["ScoreNetworkX", "ScoreNetworkA"])
def test_state_dict_names_round_trip_through_torch_convert(which):
    jdef, pdef = _nets()[which]
    jm = jload_model(jdef)
    p = _perturb_biases(jm.init(jax.random.PRNGKey(7)))
    m = load_jax_params(load_model(pdef), p)
    sd = {k: v.detach().numpy() for k, v in m.state_dict().items()}
    _tree_equal(convert(jm, sd), p)


def test_fused_definition_loads_onto_the_one_implementation():
    """A checkpoint trained with model.fused names the switch in its
    definition; the port builds the fused path from it, with the same
    parameters under the same names."""
    jcfg = jget_config("community_small", 0)
    jcfg.model.fused = True
    jdef = jload_model_params(jcfg)[1]
    assert jdef["fused"] is True
    m = load_model(jdef)
    assert all(layer.fused for layer in m.layers)
    ref = load_model(_nets()[1][1])
    assert [(k, v.shape) for k, v in m.state_dict().items()] == [
        (k, v.shape) for k, v in ref.state_dict().items()]


@pytest.mark.parametrize("which", [0, 1], ids=["ScoreNetworkX", "ScoreNetworkA"])
def test_seeded_init_is_glorot_and_deterministic(which):
    pdef = _nets()[which][1]
    a = load_model(pdef, generator=torch.Generator().manual_seed(3))
    b = load_model(pdef, generator=torch.Generator().manual_seed(3))
    for (k, u), v in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(u, v), k
        if k.endswith("bias"):
            assert not u.any(), k
        else:  # glorot bound from the (in, out) fans
            fan = sum(u.shape[-2:])
            assert u.abs().max() <= (6.0 / fan) ** 0.5, k
