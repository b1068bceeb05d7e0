"""The port's training pieces against the JAX package's, on the CPU.

Each case builds both sides from the same numpy inputs (JAX parameters
loaded into the port's networks through ccsd_tpu_torch.utils.from_jax) at
small widths: ScoreNetworkX depth 2, nhid 8; ScoreNetworkA 2
AttentionLayers, channels 2 -> 4 -> 2, adim 8, 4 heads; B = 4 graphs of
N = 8 nodes with padding.  Tolerances, each with its reason:

* data (features, split, batch order): exact;
* DSM losses on the JAX draws: rtol = 1e-5 (f32 networks that agree to
  ~1e-6 relative, squared and summed);
* gradients of every parameter, against ``jax.grad``: |got - ref| <=
  1e-4 (|ref| + max |ref|) per tensor: rounding of five f32 layers on each
  side, carried back through the backward;
* the plain backwards of the two kernels, against ``jax.grad`` of
  ``DenseGCNConv.apply`` and ``Attention.apply``: the same 1e-5 scaled
  bound as the card's kernel checks (one layer of f32 rounding);
* optimizer and EMA, against optax and ``ema_update`` on identical
  gradients: rtol = 1e-5, atol = 1e-7 (torch's Adam takes the bias
  corrections in another order than optax's).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from ccsd_tpu.data import loader as jloader
from ccsd_tpu.diffusion.losses import get_sde_loss_fn as jget_sde_loss_fn
from ccsd_tpu.diffusion.sde import load_sde as jload_sde
from ccsd_tpu.models.attention import Attention as JAttention
from ccsd_tpu.models.gcn import DenseGCNConv as JDenseGCNConv
from ccsd_tpu.models.registry import load_model as jload_model
from ccsd_tpu.models.registry import load_model_params as jload_model_params
from ccsd_tpu.ops import masks as jmasks
from ccsd_tpu.training.ema import ema_init, ema_update
from ccsd_tpu.training.optim import make_optimizer as jmake_optimizer
from ccsd_tpu.utils.config import get_config as jget_config

from ccsd_tpu_torch.data import loader
from ccsd_tpu_torch.diffusion.losses import get_sde_loss_fn
from ccsd_tpu_torch.diffusion.sde import load_sde
from ccsd_tpu_torch.kernels.gcn import gcn_aggregate_bwd_plain
from ccsd_tpu_torch.kernels.gmh_attention import gmh_attention_bwd_plain
from ccsd_tpu_torch.models.registry import load_model, load_model_params
from ccsd_tpu_torch.training.ema import EMA
from ccsd_tpu_torch.training.optim import Optimizer
from ccsd_tpu_torch.utils.config import get_config
from ccsd_tpu_torch.utils.from_jax import load_jax_params, state_dict_from_jax

B, N, F = 4, 8, 5
SMALL = {"depth": 2, "nhid": 8, "num_layers": 2, "c_init": 2, "c_hid": 4, "c_final": 2,
         "adim": 8, "num_heads": 4}


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def small_configs(sde_type="VP"):
    """(JAX config, port config) of community_small cut to SMALL widths."""
    out = []
    for get in (jget_config, get_config):
        c = get("community_small", 0)
        c.data.max_node_num, c.data.max_feat_num = N, F
        for k, v in SMALL.items():
            c.model[k] = v
        for n in ("x", "adj"):
            c.sde[n].type = sde_type
            if sde_type == "VE":
                c.sde[n].beta_min, c.sde[n].beta_max = 0.2, 1.0
        out.append(c)
    return out


def _perturb(tree, seed):
    """JAX init zeroes biases; give every leaf a nudge so all are compared."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: a + jnp.asarray(rng.standard_normal(a.shape) * 0.1, a.dtype), tree)


def small_networks(sde_type="VP", seed=0):
    """JAX models and parameters, and the port's networks holding the same
    parameters."""
    jcfg, cfg = small_configs(sde_type)
    jdefs, defs = jload_model_params(jcfg), load_model_params(cfg)
    jms = [jload_model(d) for d in jdefs]
    ps = [_perturb(m.init(jax.random.PRNGKey(seed + i)), seed + i) for i, m in enumerate(jms)]
    ms = [load_jax_params(load_model(d), p) for d, p in zip(defs, ps)]
    return jcfg, cfg, jms, ps, ms


def batch(seed=0):
    """Features and a padded symmetric 0/1 adjacency: graphs of 8, 6, 5 and
    7 nodes, features zero on the absent ones."""
    rng = np.random.default_rng(seed)
    adj = np.triu((rng.random((B, N, N)) < 0.5).astype(np.float32), 1)
    adj = adj + adj.transpose(0, 2, 1)
    for b, n in enumerate((8, 6, 5, 7)):
        adj[b, n:] = adj[b, :, n:] = 0
        adj[b, 0, 1:n] = adj[b, 1:n, 0] = 1  # every present node has an edge
    flags = (adj.sum(-1) > 0).astype(np.float32)
    x = rng.standard_normal((B, N, F)).astype(np.float32) * flags[..., None]
    return x, adj


def jax_draws(key, x, adj, sde_adj, eps):
    """The draws of the JAX loss (ccsd_tpu/diffusion/losses.py:127-139)."""
    k_t, k_zx, k_zadj = jax.random.split(key, 3)
    x, adj = jnp.asarray(x), jnp.asarray(adj)
    t = jax.random.uniform(k_t, (B,), dtype=adj.dtype) * (sde_adj.T - eps) + eps
    flags = jmasks.node_flags(adj)
    return (np.asarray(t), np.asarray(jmasks.gen_noise(k_zx, x, flags, sym=False)),
            np.asarray(jmasks.gen_noise(k_zadj, adj, flags, sym=True)))


def grad_ok(got, ref, rel):
    bound = rel * (np.abs(ref) + np.abs(ref).max())
    return bool((np.abs(got - ref) <= bound).all())


# ------------------------------------------------------------------- data


@pytest.mark.parametrize("init", ["deg", "zeros", "ones"])
def test_init_features_matches_jax(init):
    _, adj = batch(1)  # degrees up to 7
    np.testing.assert_array_equal(loader.init_features(init, adj, 8),
                                  jloader.init_features(init, adj, 8))


def test_init_features_retry_and_mismatch_match_jax():
    adj = np.zeros((1, 7, 7), np.float32)
    adj[0, 0, 1:6] = adj[0, 1:6, 0] = 1  # degree 5
    for nfeat in (5, 6):  # the +1 retry at nfeat == max degree
        np.testing.assert_array_equal(loader.init_features("deg", adj, nfeat),
                                      jloader.init_features("deg", adj, nfeat))
    with pytest.raises(ValueError, match="mismatch"):
        loader.init_features("deg", adj, 4)
    with pytest.raises(ValueError, match="mismatch"):
        jloader.init_features("deg", adj, 4)


@pytest.mark.parametrize("n,test_split", [(100, 0.2), (7, 0.3), (10, 0.0)])
def test_split_matches_jax(n, test_split):
    assert loader.split(n, test_split) == jloader._split(n, test_split)


@pytest.mark.parametrize("n,batch_size,shuffle", [(80, 128, True), (23, 5, True),
                                                  (23, 5, False)])
def test_array_dataset_order_matches_jax(n, batch_size, shuffle):
    rng = np.random.default_rng(3)
    arrays = (rng.standard_normal((n, 3)), rng.standard_normal((n, 2, 2)))
    ours = loader.ArrayDataset(arrays, batch_size, shuffle=shuffle, seed=42)
    ref = jloader.ArrayDataset(arrays, batch_size, shuffle=shuffle, seed=42)
    assert len(ours) == len(ref)
    for _ in range(3):  # three epochs: a new permutation each
        got, want = list(ours), list(ref)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            for u, v in zip(a, b):
                np.testing.assert_array_equal(u, v)


def test_community_small_split_gives_one_train_and_one_test_batch():
    """community_small at test_split 0.2 and batch_size 128: an epoch is one
    train batch of 80 graphs and one test batch of 20."""
    cfg = get_config("community_small", 0)
    adjs = loader.community_small_adjs(100, 0)
    tr, te = loader.split(len(adjs), cfg.data.test_split)
    train = loader.ArrayDataset((adjs[tr],), cfg.data.batch_size, seed=0)
    test = loader.ArrayDataset((adjs[te],), cfg.data.batch_size, seed=0)
    assert [b[0].shape[0] for b in train] == [80]
    assert [b[0].shape[0] for b in test] == [20]


# ------------------------------------------------------------------- loss


@pytest.mark.parametrize("sde_type", ["VP", "VE", "subVP"])
@pytest.mark.parametrize("reduce_mean", [False, True])
@pytest.mark.parametrize("likelihood_weighting", [False, True])
def test_dsm_loss_matches_jax_on_its_draws(sde_type, reduce_mean, likelihood_weighting):
    jcfg, cfg, jms, ps, ms = small_networks(sde_type)
    eps = 1e-5
    jsdes = [jload_sde(jcfg.sde[n]) for n in ("x", "adj")]
    sdes = [load_sde(cfg.sde[n]) for n in ("x", "adj")]
    x, adj = batch()
    key = jax.random.PRNGKey(7)
    jloss = jget_sde_loss_fn(*jsdes, *jms, reduce_mean=reduce_mean,
                             likelihood_weighting=likelihood_weighting, eps=eps)
    ref = jloss(*ps, jnp.asarray(x), jnp.asarray(adj), key)
    loss = get_sde_loss_fn(*sdes, reduce_mean=reduce_mean,
                           likelihood_weighting=likelihood_weighting, eps=eps)
    draws = [_t(d) for d in jax_draws(key, x, adj, jsdes[1], eps)]
    with torch.no_grad():
        got = loss.losses(*ms, _t(x), _t(adj), *draws)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.item(), float(r), rtol=1e-5)


def test_dsm_draws_are_masked_and_in_range():
    _, cfg, _, _, _ = small_networks()
    loss = get_sde_loss_fn(*[load_sde(cfg.sde[n]) for n in ("x", "adj")], eps=1e-3)
    x, adj = batch()
    t, z_x, z_adj = loss.draw(_t(x), _t(adj), torch.Generator().manual_seed(0))
    flags = _t(jmasks.node_flags(jnp.asarray(adj)))
    assert t.shape == (B,) and bool(((t >= 1e-3) & (t < 1.0)).all())
    assert torch.equal(z_adj, z_adj.transpose(-1, -2))
    assert not z_adj.diagonal(dim1=-2, dim2=-1).any()
    assert torch.equal(z_adj, z_adj * flags[:, :, None] * flags[:, None, :])
    assert torch.equal(z_x, z_x * flags[..., None])


@pytest.mark.parametrize("sde_type", ["VP", "VE"])
def test_loss_gradients_match_jax_grad(sde_type):
    """Every parameter's gradient of loss_x + loss_adj, the port's autograd
    (the CPU path: plain forwards) against jax.grad of the JAX loss, mapped
    onto the port's names through state_dict_from_jax."""
    jcfg, cfg, jms, ps, ms = small_networks(sde_type, seed=3)
    jsdes = [jload_sde(jcfg.sde[n]) for n in ("x", "adj")]
    x, adj = batch(2)
    key = jax.random.PRNGKey(11)
    jloss = jget_sde_loss_fn(*jsdes, *jms, eps=1e-5)
    jgrads = jax.grad(lambda p: sum(jloss(*p, jnp.asarray(x), jnp.asarray(adj), key)))(ps)
    loss = get_sde_loss_fn(*[load_sde(cfg.sde[n]) for n in ("x", "adj")], eps=1e-5)
    draws = [_t(d) for d in jax_draws(key, x, adj, jsdes[1], 1e-5)]
    sum(loss.losses(*ms, _t(x), _t(adj), *draws)).backward()
    for m, g in zip(ms, jgrads):
        ref = state_dict_from_jax(m, g)
        for name, p in m.named_parameters():
            got = p.grad.numpy() if p.grad is not None else np.zeros(p.shape, np.float32)
            assert grad_ok(got, ref[name], 1e-4), (
                name, np.abs(got - ref[name]).max(), np.abs(ref[name]).max())


# ------------------------------------------------------- plain backwards


def _tie_adj(shape, rng):
    """Noisy symmetric adjacency with node 2 absent (row sum exactly 1 after
    the loop: jnp.clip's half-gradient tie) and a negative pair (a row sum
    below 1)."""
    a = np.triu(rng.random(shape).astype(np.float32) * 0.8, 1)
    a = a + np.swapaxes(a, -1, -2)
    a[..., 2, :] = a[..., :, 2] = 0
    a[..., 0, 3] = a[..., 3, 0] = -1.5
    return a


@pytest.mark.parametrize("improved,add_loop", [(False, True), (True, True), (False, False)])
def test_gcn_plain_backward_matches_jax_grad(improved, add_loop):
    rng = np.random.default_rng(4)
    Fi, Fo = 5, 7
    x = rng.standard_normal((B, N, Fi)).astype(np.float32)
    adj = _tie_adj((B, N, N), rng)
    g = rng.standard_normal((B, N, Fo)).astype(np.float32)
    conv = JDenseGCNConv(Fi, Fo, improved=improved)
    p = _perturb(conv.init(jax.random.PRNGKey(0)), 0)

    def f(p, x, adj):
        return jnp.sum(conv.apply(p, x, adj, add_loop=add_loop) * g)

    dp, dx, dadj = jax.grad(f, argnums=(0, 1, 2))(p, jnp.asarray(x), jnp.asarray(adj))
    got = gcn_aggregate_bwd_plain(_t(x), _t(adj), _t(p["weight"]), _t(g),
                                  2.0 if improved else 1.0, add_loop)
    for a, r in zip(got, (dx, dadj, dp["weight"], dp["bias"])):
        assert grad_ok(a.numpy(), np.asarray(r), 1e-5), np.abs(a.numpy() - r).max()


@pytest.mark.parametrize("C,Fi,A,O,H", [(2, 5, 8, 8, 4), (3, 8, 12, 6, 2)])
def test_gmh_plain_backward_matches_jax_grad(C, Fi, A, O, H):
    """Per channel, jax.grad of Attention.apply (value and map) against the
    plain backward of all channels at once; x's gradient sums the
    channels'."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, N, Fi)).astype(np.float32)
    adj = _tie_adj((B, C, N, N), rng)
    gv = rng.standard_normal((B, N, C * O)).astype(np.float32)
    ga = rng.standard_normal((B, N, N, C)).astype(np.float32)
    att = JAttention(Fi, A, O, num_heads=H, conv="GCN")
    ps = [_perturb(att.init(jax.random.PRNGKey(c)), c) for c in range(C)]
    dx_ref = 0
    refs = []
    for c, p in enumerate(ps):
        def f(p, x, a):
            v, m = att.apply(p, x, a, None)
            return jnp.sum(v * gv[..., c * O:(c + 1) * O]) + jnp.sum(m * ga[..., c])

        dp, dx, da = jax.grad(f, argnums=(0, 1, 2))(p, jnp.asarray(x), jnp.asarray(adj[:, c]))
        dx_ref = dx_ref + np.asarray(dx)
        refs.append((dp, np.asarray(da)))
    st = lambda m, leaf: torch.stack([_t(p[m][leaf]) for p in ps])  # noqa: E731
    got = gmh_attention_bwd_plain(_t(x), _t(adj), st("q", "weight"), st("q", "bias"),
                                  st("k", "weight"), st("k", "bias"), st("v", "weight"),
                                  st("v", "bias"), _t(gv), _t(ga), H, O)
    assert grad_ok(got[0].numpy(), dx_ref, 1e-5)
    for c, (dp, da) in enumerate(refs):
        assert grad_ok(got[1][:, c].numpy(), da, 1e-5), np.abs(got[1][:, c].numpy() - da).max()
        for i, (m, leaf) in enumerate([(m, leaf) for m in "qkv" for leaf in ("weight", "bias")]):
            assert grad_ok(got[2 + i][c].numpy(), np.asarray(dp[m][leaf]), 1e-5), (c, m, leaf)


# ------------------------------------------------------ optimizer and EMA


class _Params(torch.nn.Module):
    def __init__(self, arrays):
        super().__init__()
        self.ps = torch.nn.ParameterList(torch.nn.Parameter(_t(a)) for a in arrays)


@pytest.mark.parametrize("grad_norm", [1.0, None])
@pytest.mark.parametrize("lr_schedule", [True, False])
def test_optimizer_and_ema_match_optax(grad_norm, lr_schedule):
    """Five steps on identical gradients, two steps an epoch (so the rate
    decays twice); large gradients in steps 1 and 3 (clipped when
    grad_norm is set), small ones otherwise; the third tensor never gets a
    gradient in the port (None) and a zero one in JAX, as a parameter
    outside the loss."""
    rng = np.random.default_rng(6)
    shapes = [(3, 4), (4,), (2, 2)]
    init = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) * (5.0 if k % 2 == 0 else 0.05)
              for s in shapes] for k in range(5)]
    for gs in grads:
        gs[2] = np.zeros_like(gs[2])
    kw = dict(lr=0.01, weight_decay=1e-4, grad_norm=grad_norm, lr_schedule=lr_schedule,
              lr_decay=0.9, steps_per_epoch=2)
    jopt = jmake_optimizer(**kw)
    jp = [jnp.asarray(a) for a in init]
    jstate, jema = jopt.init(jp), ema_init(jp, 0.999)
    module = _Params(init)
    opt = Optimizer(module.parameters(), **kw)
    ema = EMA(module, 0.999)
    for gs in grads:
        upd, jstate = jopt.update([jnp.asarray(g) for g in gs], jstate, jp)
        jp = optax.apply_updates(jp, upd)
        jema = ema_update(jema, jp)
        opt.zero_grad()
        for p, g in zip(module.ps[:2], gs[:2]):
            p.grad = _t(g)
        opt.step()
        ema.update(module)
    adam = next(s for s in jstate if hasattr(s, "mu"))
    tol = dict(rtol=1e-5, atol=1e-7)
    for i, p in enumerate(module.ps):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[i]), **tol)
        st = opt.adam.state[p]
        np.testing.assert_allclose(st["exp_avg"].numpy(), np.asarray(adam.mu[i]), **tol)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), np.asarray(adam.nu[i]), **tol)
        np.testing.assert_allclose(ema.shadow_params[i].numpy(),
                                   np.asarray(jema.shadow_params[i]), **tol)
    assert ema.num_updates == int(jema.num_updates) == opt.count == 5


def test_clip_uses_optax_rule_not_clip_grad_norm():
    """At a global norm of exactly max_norm optax leaves the gradient as it
    is; clip_grad_norm_ would scale it by max_norm / (norm + 1e-6)."""
    p = torch.nn.Parameter(torch.zeros(2))
    opt = Optimizer([p], lr=0.1, grad_norm=5.0)
    p.grad = torch.tensor([3.0, 4.0])
    opt.clip()
    assert torch.equal(p.grad, torch.tensor([3.0, 4.0]))
    p.grad = torch.tensor([30.0, 40.0])
    opt.clip()
    torch.testing.assert_close(p.grad, torch.tensor([3.0, 4.0]), rtol=1e-7, atol=0)
