"""The port's Trainer in CC mode against the JAX package's, on the CPU.

* One epoch of a CC ``Trainer`` (two steps at batch 4 on 8 training
  graphs, then the test losses under the EMA weights) from the JAX init on
  the JAX draws, against the JAX package's own ``_train_step`` and
  ``_eval_step`` (its ``Trainer._make_*_step`` on an instance given the JAX
  CC loss and optimizers): the three losses of each step and of the test
  batch within rtol = 1e-4, and after the epoch every parameter, Adam
  moment and EMA shadow of the three networks within rtol = 1e-4, atol =
  2e-6: the graph trainer's test holds atol = 1e-6, but the Hodge
  attention's Q weights take gradients summed over K = 56 cells, and Adam
  divides each by its own root mean square, so one element of 224 lands
  1.07e-6 past rtol (measured).
* Save, then resume in a new Trainer: bit for bit the uninterrupted run,
  and the checkpoint carries ``rank2``'s entries.

Sizes: N = 8 (E = 28, K = 56), the networks of tests/test_torch_cc_models.py.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from ccsd_tpu.diffusion.losses import get_sde_loss_fn_cc as jget_sde_loss_fn_cc
from ccsd_tpu.diffusion.sde import load_sde as jload_sde
from ccsd_tpu.models.registry import load_model as jload_model
from ccsd_tpu.models.registry import load_model_params as jload_model_params
from ccsd_tpu.ops import masks as jmasks
from ccsd_tpu.training.ema import ema_init
from ccsd_tpu.training.optim import make_optimizer as jmake_optimizer
from ccsd_tpu.training.trainer import Trainer as JTrainer

from ccsd_tpu_torch.training.checkpoint import load_port_ckpt
from ccsd_tpu_torch.training.ema import EMA
from ccsd_tpu_torch.training.trainer import Trainer
from ccsd_tpu_torch.utils.from_jax import load_jax_params, state_dict_from_jax

from test_torch_cc_models import JSPEC, _perturb, small_cc_configs
from test_torch_cc_sampler import ring_adjs

NAMES = ("x", "adj", "rank2")


def _config(cfg, name="cc", epochs=1):
    cfg.train.name, cfg.train.num_epochs = name, epochs
    cfg.train.save_interval, cfg.train.print_interval = 1, 1
    cfg.train.lr_decay = 0.5
    cfg.data.batch_size = 4
    return cfg


def _jax_draws(key, x, adj, rank2, sde_adj, eps):
    """The draws of the JAX CC loss (ccsd_tpu/diffusion/losses.py:186-205)."""
    k_t, k_zx, k_zadj, k_zr2 = jax.random.split(key, 4)
    x, adj, rank2 = jnp.asarray(x), jnp.asarray(adj), jnp.asarray(rank2)
    t = jax.random.uniform(k_t, (adj.shape[0],), dtype=adj.dtype) * (sde_adj.T - eps) + eps
    flags = jmasks.node_flags(adj)
    return [torch.from_numpy(np.array(d)) for d in (
        t, jmasks.gen_noise(k_zx, x, flags, sym=False),
        jmasks.gen_noise(k_zadj, adj, flags, sym=True),
        jmasks.gen_noise_rank2(k_zr2, rank2, JSPEC, flags))]


def test_one_cc_epoch_matches_the_jax_trainer():
    jcfg, cfg = (_config(c) for c in small_cc_configs())
    tc = jcfg.train
    # 10 graphs, 8 for training at batch 4: two steps an epoch, a test batch of 2
    trainer = Trainer(cfg, device="cpu", adjs=ring_adjs(10, 8), log=False)
    assert len(trainer.train_loader) == 2 and trainer.names == NAMES
    jms = [jload_model(d) for d in jload_model_params(jcfg, is_cc=True)]
    ps = [_perturb(m.init(jax.random.PRNGKey(10 + i)), 10 + i) for i, m in enumerate(jms)]
    for n, p in zip(NAMES, ps):
        load_jax_params(trainer.models[n], p)
        trainer.emas[n] = EMA(trainer.models[n], tc.ema)

    jt = object.__new__(JTrainer)  # the JAX steps, without JAX's data loading
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

    keys = iter(jax.random.split(jax.random.PRNGKey(3), 3))
    jlosses = []

    def feed(*batch):
        key = next(keys)
        trainer.loss_fn.draw = lambda *a, d=_jax_draws(key, *batch, jsdes[1], tc.eps): d
        return key

    train_draw = trainer.loss_fn.draw
    for batch in trainer.train_loader:
        key = feed(*batch)
        params, opts, emas, jl = step(params, opts, emas, tuple(map(jnp.asarray, batch)), key)
        jlosses.append(jl)
        got = trainer.train_step(*batch)
        np.testing.assert_allclose(got.numpy(), np.asarray(jl), rtol=1e-4)
    for n in NAMES:
        trainer.emas[n].copy_to(trainer.eval_models[n])
    (batch,) = list(trainer.test_loader)
    key = feed(*batch)
    want = eval_step(emas, tuple(map(jnp.asarray, batch)), key)
    got = trainer.eval_step(*batch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)
    trainer.loss_fn.draw = train_draw

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


def _run(tmp_path, name, epochs, resume=None):
    cfg = _config(small_cc_configs()[1], name=name, epochs=epochs)
    cfg.folder = str(tmp_path)
    t = Trainer(cfg, device="cpu", adjs=ring_adjs(10, 8, seed=1))
    if resume:
        t.load_checkpoint(resume)
    t.train()
    return t


def test_cc_resume_reproduces_the_uninterrupted_run_bit_for_bit(tmp_path):
    full = _run(tmp_path, "full", 3)
    half = _run(tmp_path, "half", 2)
    ckpt = load_port_ckpt(half.checkpoint_path(f"{half.ckpt_name}_final"))
    assert {"params_rank2", "rank2_state_dict", "ema_rank2", "rank2_opt_state"} <= set(ckpt)
    resumed = _run(tmp_path, "resumed", 3, resume=f"{half.ckpt_name}_final")
    assert resumed.epoch == full.epoch == 3 and resumed.step == full.step == 6
    assert resumed.history == full.history and len(full.history["train"][0]) == 3
    for n in NAMES:
        for (k, a), b in zip(full.models[n].state_dict().items(),
                             resumed.models[n].state_dict().values()):
            assert torch.equal(a, b), k
        for a, b in zip(full.emas[n].shadow_params, resumed.emas[n].shadow_params):
            assert torch.equal(a, b)
