"""The grid family in the port against the JAX package, on the CPU.

* The plain versions the tiled kernels are held to on the card
  (``gmh_scores_plain``, ``gmh_attention_plain``, ``gmh_projection_plain``)
  at N = 100 (a ragged last tile) and grid's N = 361, B = 1, C = 2, against
  the JAX probe body ``make_pallas`` (tools/pallas_scores_probe.py) and
  ``gmh_attention_pallas``, both in interpret mode.  Tolerance rtol = atol
  = 1e-5 in f32 (the sides sum in other orders); the bf16 scores against
  the probe, which rounds every product and partial sum to bf16, within
  the bound of tests/test_torch_fused_kernels.py (``_probe_bound``).
* ScoreNetworkX (depth 5) and ScoreNetworkA (7 AttentionLayers, channels
  2 -> 8 x 6 -> 4) at grid_small's config against the JAX networks on the
  same weights: rtol = atol = 1e-4, as tests/test_torch_models.py holds
  whole networks.
* ``Sampler`` at grid_small's config (Reverse + Langevin, snr 0.1,
  scale_eps 0.7) from a port checkpoint's EMA weights (``use_ema: true``)
  against the JAX sampler on those weights with shared noise, 3 steps:
  |port - JAX| <= 1e-4 (|JAX| + max |JAX|) per output, the scaled bound of
  tests/test_torch_train_parity.py: the outputs reach |x| ~ 30, where f32
  rounding of the 12 score evaluations moves an entry near zero by ~2e-4.
* ``Trainer`` for 2 epochs on grid_small's generated dataset (ten train
  batches of 8 and three test batches: 8, 8 and 4 graphs) at narrow widths:
  every train and test loss against the JAX loss at the same parameters
  and draws, rtol = 1e-5 (the networks agree to ~1e-6 relative), and the
  epoch means taken over batches as the JAX Trainer takes them.
* ``cli`` trains and samples grid_small with no ``--train-adjs``.
* On the card, ``Trainer`` on grid (N = 361, its published widths) takes
  a step through the tiled backward kernels, with exact launch counts;
  ``cuda``-marked, skipped here.
"""

import json
import math
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import ccsd_tpu.diffusion.solvers as jsolvers
from ccsd_tpu.diffusion import sde as jsde
from ccsd_tpu.diffusion.losses import get_score_fn as jget_score_fn
from ccsd_tpu.diffusion.losses import get_sde_loss_fn as jget_sde_loss_fn
from ccsd_tpu.diffusion.sde import load_sde as jload_sde
from ccsd_tpu.models.registry import load_model as jload_model
from ccsd_tpu.models.registry import load_model_params as jload_model_params
from ccsd_tpu.models.registry import with_fused as jwith_fused
from ccsd_tpu.ops import masks as jmasks
from ccsd_tpu.ops.pallas.gmh_attention import gmh_attention_pallas
from ccsd_tpu.utils.config import get_config as jget_config
from ccsd_tpu.utils.torch_convert import convert

import ccsd_tpu_torch.diffusion.solvers as psolvers
import ccsd_tpu_torch.sampling.sampler as psampler
from ccsd_tpu_torch.data.loader import generated_adjs, init_features, split
from ccsd_tpu_torch.diffusion import sde as psde
from ccsd_tpu_torch.kernels.gcn import gcn_degrees_plain
from ccsd_tpu_torch.kernels.gmh_attention import gmh_attention_plain, gmh_projection_plain
from ccsd_tpu_torch.kernels.gmh_scores import gmh_scores_plain, head_scores
from ccsd_tpu_torch.models.registry import load_model, load_model_params, with_fused
from ccsd_tpu_torch.training.ema import EMA
from ccsd_tpu_torch.training.trainer import Trainer
from ccsd_tpu_torch.utils.config import get_config
from ccsd_tpu_torch.utils.from_jax import load_jax_params

from test_torch_fused_kernels import _probe, _probe_bound, _qk, bf16_ulp
from test_torch_kernels import _jax_attention_params, _stack
from test_torch_models import _perturb_biases
from test_torch_sampler import _noise_feed
from test_torch_train_parity import _perturb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)
NET_TOL = dict(rtol=1e-4, atol=1e-4)
GS = "grid_small"


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _grid_adj(B, C, N, seed):
    """A symmetric 0/1 adjacency of mean degree 4, as grid's graphs have."""
    rng = np.random.default_rng(seed)
    a = np.triu((rng.random((B, C, N, N)) < 4 / N).astype(np.float32), 1)
    return a + np.swapaxes(a, -1, -2)


# ------------------------------------------------ the tiled kernels' plain


@pytest.mark.parametrize("N", [100, 361])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gmh_scores_plain_matches_probe_past_one_block(N, dtype):
    B, C, A, H, O = 1, 2, 32, 4, 32
    mod = _probe("pallas_scores_probe", B=B, C=C, N=N, A=A, H=H, O=O, DS=A // H,
                 INV=1.0 / math.sqrt(O))
    q, k = _qk(B, C, N, A)
    ql, kl = (np.ascontiguousarray(a.transpose(1, 3, 2, 0)) for a in (q, k))  # (C, A, N, B)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    ref = np.asarray(mod.make_pallas(jdt)(ql, kl)).transpose(3, 0, 1, 2)  # (B, C, N, N)
    bf16 = dtype == "bf16"
    att = head_scores(_t(q), _t(k), H, O, bf16=bf16).numpy()
    out = gmh_scores_plain(_t(q), _t(k), H, O, bf16=bf16).numpy()
    sym = ((ref + np.swapaxes(ref, -1, -2)) / 2).transpose(0, 2, 3, 1)
    if bf16:
        bound = _probe_bound(q, k, H, O)
        assert (np.abs(att - ref) <= bound).all(), np.abs(att - ref).max()
        sb = ((bound + np.swapaxes(bound, -1, -2)) / 2).transpose(0, 2, 3, 1)
        assert (np.abs(out - sym) <= sb).all()
    else:
        np.testing.assert_allclose(att, ref, **TOL)
        np.testing.assert_allclose(out, sym, **TOL)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gmh_scores_plain_matches_jax_expressions_past_one_block(dtype):
    """The plain version the tile-pair stage is held to on the card, at a
    tiled N (B = 1, C = 2, N = 100: three tiles of 32 and one of 4), against
    the JAX package's own score expressions under jit: f32 against the
    probe's ``scores_jnp`` (tools/pallas_scores_probe.py), rtol = atol =
    1e-5; bf16 against the model's ``mulreduce_h_bf16`` path
    (ccsd_tpu/models/attention.py:305-318: Q and K in bf16, each head's sum
    from bf16, tanh in f32), within one bf16 ulp of the largest head sum
    over sqrt(O) plus 1e-5, as tests/test_torch_fused_kernels.py holds it at
    small N; both symmetrised and channels-last as the layer returns them."""
    B, C, N, A, H, O = 1, 2, 100, 32, 4, 32
    ds = A // H
    q, k = _qk(B, C, N, A, scale=1.0, seed=3)
    if dtype == "f32":
        mod = _probe("pallas_scores_probe", B=B, C=C, N=N, A=A, H=H, O=O, DS=ds,
                     INV=1.0 / math.sqrt(O))
        ql, kl = (np.ascontiguousarray(a.transpose(1, 3, 2, 0)) for a in (q, k))
        ref = np.asarray(mod.scores_jnp(ql, kl)).transpose(3, 0, 1, 2)  # (B, C, N, N)
        tol = dict(rtol=1e-5, atol=1e-5)
    else:
        @jax.jit
        def model_path(Q, K):
            Qh = Q.reshape(B, C, N, H, ds).astype(jnp.bfloat16)
            Kh = K.reshape(B, C, N, H, ds).astype(jnp.bfloat16)
            acc = None
            for h in range(H):
                s = (Qh[:, :, :, None, h, :] * Kh[:, :, None, :, h, :]).sum(-1)
                t = jnp.tanh(s.astype(jnp.float32) / math.sqrt(O))
                acc = t if acc is None else acc + t
            return acc / H

        ref = np.asarray(model_path(q, k))
        s_max = np.abs(np.einsum("bcnhd,bcmhd->bchnm", q.reshape(B, C, N, H, ds),
                                 k.reshape(B, C, N, H, ds))).max()
        tol = dict(rtol=0.0, atol=float(bf16_ulp(s_max)) / math.sqrt(O) + 1e-5)
    sym = ((ref + np.swapaxes(ref, -1, -2)) / 2).transpose(0, 2, 3, 1)
    out = gmh_scores_plain(_t(q), _t(k), H, O, bf16=dtype == "bf16").numpy()
    np.testing.assert_allclose(out, sym, **tol)
    if dtype == "bf16":  # and bf16 rounding moves the map here by more than f32 rounding
        f32 = gmh_scores_plain(_t(q), _t(k), H, O).numpy()
        assert np.abs(f32 - sym).max() > 1e-4


@pytest.mark.parametrize("N", [100, 361])
def test_gmh_attention_and_projection_plain_match_pallas_past_one_block(N):
    """grid's first layer (C = 2 on F_in 5) at B = 1: V and the maps of
    every channel against gmh_attention_pallas; the projection's V the
    same, its Q | K against the same product in JAX."""
    B, C, Fi, A, O, H = 1, 2, 5, 32, 32, 4
    x = np.random.default_rng(2).standard_normal((B, N, Fi)).astype(np.float32)
    adj = _grid_adj(B, C, N, 3)
    att, ps = _jax_attention_params(Fi, A, O, H, C, seed=4)
    w = [_stack(ps, m, leaf) for m in "qkv" for leaf in ("weight", "bias")]
    v, a = gmh_attention_plain(_t(x), _t(adj), *w, H, O)
    qk, vp = gmh_projection_plain(_t(x), _t(adj), gcn_degrees_plain(_t(adj)), *w)
    torch.testing.assert_close(vp, v, **TOL)
    for c, p in enumerate(ps):
        xj, aj = jnp.asarray(x), jnp.asarray(adj[:, c])
        V, M = gmh_attention_pallas(xj, aj, p["q"]["weight"], p["q"]["bias"], p["k"]["weight"],
                                    p["k"]["bias"], p["v"]["weight"], p["v"]["bias"], H, O)
        np.testing.assert_allclose(v[..., c * O:(c + 1) * O].numpy(), np.asarray(V), **TOL)
        np.testing.assert_allclose(a[..., c].numpy(), np.asarray(M), **TOL)
        a1 = aj.at[:, jnp.arange(N), jnp.arange(N)].set(1.0)
        d = jax.lax.rsqrt(jnp.maximum(a1.sum(-1), 1.0))
        nx = (d[..., :, None] * a1 * d[..., None, :]) @ xj
        for i, m in enumerate("qk"):
            ref = nx @ p[m]["weight"] + p[m]["bias"]
            np.testing.assert_allclose(qk[:, c, :, i * A:(i + 1) * A].numpy(), np.asarray(ref),
                                       **TOL)


# --------------------------------------------------- grid_small networks


def _gs_networks(seed):
    """(JAX models, their parameters with non-zero biases, port defs) at
    grid_small, as tests/test_torch_models.py initialises whole networks."""
    jdefs = jload_model_params(jget_config(GS, 0))
    jms = [jload_model(d) for d in jdefs]
    ps = [_perturb_biases(m.init(jax.random.PRNGKey(seed + i)), seed + i)
          for i, m in enumerate(jms)]
    return jms, ps, load_model_params(get_config(GS, 0))


def _gs_inputs(B=2, seed=0):
    adj = generated_adjs(GS, seed, 49)[:B]
    x = init_features("deg", adj, 5)
    rng = np.random.default_rng(seed)
    flags = (adj.sum(-1) > 0).astype(np.float32)
    noisy = adj + np.triu(rng.standard_normal(adj.shape).astype(np.float32) * 0.3, 1)
    noisy = (np.triu(noisy, 1) + np.swapaxes(np.triu(noisy, 1), -1, -2)) * flags[:, :, None] \
        * flags[:, None, :]
    return x, noisy.astype(np.float32), flags


@pytest.mark.parametrize("which,fused", [(0, False), (1, False), (1, True)],
                         ids=["ScoreNetworkX", "ScoreNetworkA", "ScoreNetworkA_fused_f32"])
def test_score_networks_at_grid_small_match_jax(which, fused):
    jms, ps, defs = _gs_networks(5)
    d = with_fused({"adj": defs[1]}, True, fast=False)["adj"] if fused else defs[which]
    if which == 1:
        assert len(jms[1].layers) == 7 and d["c_hid"] == 8 and d["c_final"] == 4
    else:
        assert d["depth"] == 5
    m = load_jax_params(load_model(d), ps[which])
    x, adj, flags = _gs_inputs()
    ref = jms[which].apply(ps[which], jnp.asarray(x), jnp.asarray(adj), flags=jnp.asarray(flags))
    with torch.no_grad():
        out = m(_t(x), _t(adj), _t(flags))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **NET_TOL)


# ------------------------------------------------------ grid_small sampler

STEPS = 3


def _gs_config(tmp_path, epochs=1):
    cfg = get_config(GS, 0, ROOT)
    cfg.folder = str(tmp_path)
    cfg.train.num_epochs, cfg.train.save_interval = epochs, epochs
    for k in ("x", "adj"):
        cfg.sde[k].num_scales = STEPS
    return cfg


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused_f32"])
def test_grid_small_sampler_from_ema_checkpoint_matches_jax(monkeypatch, tmp_path, fused):
    """One epoch of the port's Trainer writes a checkpoint whose EMA weights
    differ from its raw ones; the Sampler loads the EMA ones (the config's
    use_ema: true) and samples with Reverse + Langevin; the JAX sampler on
    the same weights, flags and noise gives the same graphs before
    quantisation.  The unfused and the fused f32 network (``sample.fast:
    false``): with these weights a bf16 head sum that the two packages' f32
    orders round to neighbouring bf16 values moves the outputs by ~1e-3 of
    their scale (measured), so the default fast path is held at small
    widths with a damped head (tests/test_torch_sampler.py) and run at
    grid_small on the card (chip_smoke.py)."""
    cfg = _gs_config(tmp_path)
    assert cfg.sample.use_ema and (cfg.sampler.predictor, cfg.sampler.corrector) == (
        "Reverse", "Langevin")
    adjs = generated_adjs(GS, 0, 49)[:10]
    trainer = Trainer(cfg, device="cpu", adjs=adjs, log=False)
    trainer.train()
    cfg.ckpt, cfg.sample.fused, cfg.sample.fast = "ckpt_final", fused, False
    tr, _ = split(len(adjs), float(cfg.data.test_split))
    sampler = psampler.Sampler(cfg, adjs[tr], device="cpu", log=False)
    _, models, source = sampler.load_models()
    assert source.endswith("(ema params)")
    for n in ("x", "adj"):
        ema = trainer.emas[n].shadow_params
        assert all(torch.equal(p, e) for p, e in zip(models[n].parameters(), ema))
        assert not all(torch.equal(p, q) for p, q in
                       zip(models[n].parameters(), trainer.models[n].parameters()))

    B, N, F = int(cfg.data.batch_size), 49, 5
    rng = np.random.default_rng(11)
    shapes = [(B, N, F), (B, N, N)] * (1 + 2 * STEPS)
    seq = [rng.standard_normal(s).astype(np.float32) for s in shapes]

    # JAX: the same weights, the Sampler's flags, the shared noise
    jcfg = jget_config(GS, 0)
    for k in ("x", "adj"):
        jcfg.sde[k].num_scales = STEPS
    jdefs = jload_model_params(jcfg)
    if fused:
        jdefs = [jdefs[0], jwith_fused({"adj": jdefs[1]}, True, fast=False)["adj"]]
    jms = [jload_model(d) for d in jdefs]
    jps = [convert(jm, {k: v.detach().numpy() for k, v in models[n].state_dict().items()})
           for jm, n in zip(jms, ("x", "adj"))]
    flags = psampler.init_flags(sampler.train_adjs, B,
                                np.random.default_rng(int(cfg.sample.seed)))
    jraw = _noise_feed(seq, jnp.asarray)

    def jgen(key, x, fl, sym=True):
        z = jraw(x.shape)
        if sym:
            z = jnp.triu(z, 1)
            return jsolvers.mask_adjs(z + jnp.swapaxes(z, -1, -2), fl)
        return jsolvers.mask_x(z, fl)

    monkeypatch.setattr(jsolvers, "gen_noise", jgen)
    monkeypatch.setattr(jsde.VPSDE, "prior_sampling",
                        lambda self, key, shape, dtype=None: jraw(shape))
    monkeypatch.setattr(jsde.VPSDE, "prior_sampling_sym",
                        lambda self, key, shape, dtype=None: (
                            lambda z: z + jnp.swapaxes(z, -1, -2))(jnp.triu(jraw(shape), 1)))
    jsdes = [jload_sde(jcfg.sde[k]) for k in ("x", "adj")]
    sc, sm = cfg.sampler, cfg.sample
    run = jsolvers.get_pc_sampler(*jsdes, (B, N, F), (B, N, N), predictor=sc.predictor,
                                  corrector=sc.corrector, snr=sc.snr, scale_eps=sc.scale_eps,
                                  n_steps=sc.n_steps, probability_flow=sm.probability_flow,
                                  denoise=sm.noise_removal, eps=sm.eps)
    with jax.disable_jit():
        jout = run(*[jget_score_fn(s, m, p) for s, m, p in zip(jsdes, jms, jps)],
                   jnp.asarray(flags), jax.random.PRNGKey(0))

    praw = _noise_feed(seq, torch.from_numpy)

    def pgen(x, fl, sym=True, generator=None):
        z = praw(x.shape)
        if sym:
            z = torch.triu(z, 1)
            return psolvers.mask_adjs(z + z.transpose(-1, -2), fl)
        return psolvers.mask_x(z, fl)

    monkeypatch.setattr(psolvers, "gen_noise", pgen)
    monkeypatch.setattr(psde.VPSDE, "prior_sampling",
                        lambda self, shape, generator=None, device=None: praw(shape))
    monkeypatch.setattr(psde.VPSDE, "prior_sampling_sym",
                        lambda self, shape, generator=None, device=None: (
                            lambda z: z + z.transpose(-1, -2))(torch.triu(praw(shape), 1)))
    monkeypatch.setattr(psampler, "quantize", lambda a: a)  # compare before quantising
    res = sampler.sample(B)
    np.testing.assert_array_equal(res["flags"], flags)
    for got, want in ((res["x"], np.asarray(jout.x)), (res["adj"], np.asarray(jout.adj))):
        assert np.isfinite(got).all() and got.shape == want.shape
        bound = 1e-4 * (np.abs(want) + np.abs(want).max())
        assert (np.abs(got - want) <= bound).all(), np.abs(got - want).max()


# ------------------------------------------------------ grid_small trainer

NARROW = {"depth": 2, "nhid": 8, "num_layers": 3, "c_init": 2, "c_hid": 4, "c_final": 2,
          "adim": 8, "num_heads": 4}


def _draws(key, x, adj, sde_adj, eps):
    """The draws of the JAX loss (ccsd_tpu/diffusion/losses.py:127-139)."""
    k_t, k_zx, k_zadj = jax.random.split(key, 3)
    t = jax.random.uniform(k_t, (adj.shape[0],), dtype=adj.dtype) * (sde_adj.T - eps) + eps
    flags = jmasks.node_flags(adj)
    return [_t(t), _t(jmasks.gen_noise(k_zx, x, flags, sym=False)),
            _t(jmasks.gen_noise(k_zadj, adj, flags, sym=True))]


def test_grid_small_trainer_two_epochs_match_jax():
    """Two epochs of the port's Trainer on grid_small's 100 generated graphs:
    each epoch ten train steps, then the test loss under the EMA weights
    over three batches (8, 8 and 4 graphs).  Every loss the run computes,
    train and test, equals the JAX loss (ccsd_tpu/diffusion/losses.py) at
    the port's parameters of that moment on the same JAX draws, within
    rtol = 1e-5; each epoch's logged means are the unweighted means over
    its batches, as ccsd_tpu/training/trainer.py:333-334 takes them.  Two
    independent 20-step trajectories are not compared: f32 differences of
    ~1e-7 cross the degree clamp's kink and Adam's normalisation and grow
    to ~1e-2 of the adjacency loss (measured on the CPU), in either package
    against a float64 copy alike."""
    jcfg, cfg = jget_config(GS, 0), get_config(GS, 0)
    for c in (jcfg, cfg):
        for k, v in NARROW.items():
            c.model[k] = v
        c.train.num_epochs = 2
    tc = jcfg.train
    seed = int(cfg.get("seed", 42))
    trainer = Trainer(cfg, device="cpu", log=False)  # grid_small generated from the seed
    np.testing.assert_array_equal(trainer.train_loader.arrays[1],
                                  generated_adjs(GS, seed, 49)[split(100, 0.2)[0]])
    assert (len(trainer.train_loader), len(trainer.test_loader)) == (10, 3)
    assert [len(b[0]) for b in trainer.test_loader] == [8, 8, 4]
    jms = [jload_model(d) for d in jload_model_params(jcfg)]
    ps = [_perturb(m.init(jax.random.PRNGKey(20 + i)), 20 + i) for i, m in enumerate(jms)]
    for n, p in zip(("x", "adj"), ps):
        load_jax_params(trainer.models[n], p)
        trainer.emas[n] = EMA(trainer.models[n], tc.ema)
    jsdes = [jload_sde(jcfg.sde[n]) for n in ("x", "adj")]
    loss = jax.jit(jget_sde_loss_fn(*jsdes, *jms, reduce_mean=tc.reduce_mean, eps=tc.eps))

    key, calls = [jax.random.PRNGKey(seed)], []

    def draw(x, adj, gen):  # the JAX draws of the next key, recorded with the batch
        key[0], sub = jax.random.split(key[0])
        calls.append([sub, x.numpy(), adj.numpy()])
        return _draws(sub, jnp.asarray(x.numpy()), jnp.asarray(adj.numpy()), jsdes[1], tc.eps)

    def recording(step, nets):
        def run(x, adj):
            sd = {n: {k: v.detach().numpy().copy() for k, v in nets[n].state_dict().items()}
                  for n in ("x", "adj")}
            out = step(x, adj)
            calls[-1] += [sd, out.numpy()]
            return out
        return run

    trainer.loss_fn.draw = draw
    trainer.train_step = recording(trainer.train_step, trainer.models)
    trainer.eval_step = recording(trainer.eval_step, trainer.eval_models)
    trainer.train()
    assert len(calls) == 2 * 13 and trainer.step == 20
    ref = []
    for sub, x, adj, sd, got in calls:
        jp = [convert(m, sd[n]) for m, n in zip(jms, ("x", "adj"))]
        want = np.asarray(loss(*jp, jnp.asarray(x), jnp.asarray(adj), sub))
        np.testing.assert_allclose(got, want, rtol=1e-5)
        ref.append(want)
    for e in range(2):
        epoch = ref[13 * e:13 * (e + 1)]
        np.testing.assert_allclose(trainer.history["train"][e], np.mean(epoch[:10], axis=0),
                                   rtol=1e-5)
        np.testing.assert_allclose(trainer.history["test"][e], np.mean(epoch[10:], axis=0),
                                   rtol=1e-5)


# ----------------------------------------------------------------- entries


def test_cli_trains_and_samples_grid_small_without_train_adjs(tmp_path, capsys):
    """The dataset is generated from the seed: the CLI needs no file."""
    from ccsd_tpu_torch import cli

    with open(os.path.join(ROOT, "config", f"{GS}.yaml")) as f:
        text = f.read()
    for a, b in {"num_epochs: 5000": "num_epochs: 1", "save_interval: 2500": "save_interval: 1",
                 "print_interval: 500": "print_interval: 1", "num_scales: 1000": "num_scales: 2",
                 "  seed: 12": "  seed: 12\n  eval: false"}.items():
        assert a in text
        text = text.replace(a, b)
    for k, v in NARROW.items():
        text = text.replace(f"\n  {k}: ", f"\n  {k}: {v}  # was ", 1)
    os.makedirs(tmp_path / "config")
    (tmp_path / "config" / "tiny_grid.yaml").write_text(text)
    base = ["--config", "tiny_grid", "--folder", str(tmp_path), "--device", "cpu"]
    assert cli.main(["--type", "train", *base]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["epochs"] == 1 and out["steps"] == 10 and os.path.exists(out["ckpt_path"])
    with open(tmp_path / "config" / "tiny_grid.yaml", "a") as f:
        f.write(f"ckpt: {out['ckpt']}\n")
    assert cli.main(["--type", "sample", *base, "--out", str(tmp_path / "s.npz")]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["samples"] == 20 and res["finite"] and "(ema params)" in res["weights"]
    assert np.load(tmp_path / "s.npz")["adj"].shape == (20, 49, 49)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the tiled backward kernels run only on the "
                    "card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_trainer_on_grid_takes_a_step_on_card(cuda, tmp_path):
    """``Trainer`` on config/grid.yaml, at its published widths (B = 8,
    N = 361), takes a train step on the card: finite losses, and every
    kernel launched exactly as the forward and the tiled backward of
    ScoreNetworkX's 5 GCN layers and ScoreNetworkA's 7 AttentionLayers
    give (each backward layer: a ``gcn_degrees`` pass, and for attention
    ``gmh_projection``, the layout pass and ``gmh_score_grad`` before the
    row-tile kernel)."""
    from ccsd_tpu_torch.kernels import LAUNCHES

    cfg = get_config("grid", 0, ROOT)
    cfg.folder = str(tmp_path)
    trainer = Trainer(cfg, device=cuda, log=False)
    x, adj = next(iter(trainer.train_loader))
    assert adj.shape == (8, 361, 361)
    before = dict(LAUNCHES)
    losses = trainer.train_step(x, adj)
    torch.cuda.synchronize()
    depth, L = 5, 7
    want = {"gcn_aggregate": depth, "gmh_attention": L, "gmh_projection": 2 * L,
            "gcn_degrees": 2 * (depth + L), "gcn_aggregate_bwd": depth,
            "gmh_bwd_layout": L, "gmh_score_grad": L, "gmh_attention_bwd_tiled": L}
    assert {k: v - before[k] for k, v in LAUNCHES.items()} == {
        k: want.get(k, 0) for k in LAUNCHES}
    assert bool(torch.isfinite(losses).all())
