"""The port's Trainer and its entry points, on the CPU.

* Three ``Trainer`` steps from the JAX init on the JAX draws against the
  JAX package's own ``_train_step`` (its ``Trainer._make_train_step``, run
  on an instance given the JAX loss and optimizers): parameters, Adam
  moments and EMA shadows after the three steps, within rtol = 1e-4,
  atol = 1e-6 (gradients that agree to ~1e-5 relative, through Adam's
  normalisation and three updates).
* Save, then resume in a new Trainer: bit for bit the uninterrupted run
  (parameters, optimizer and EMA states, history), and the checkpoint loads
  with ``weights_only=True`` in the reference's layout.
* ``cli --type train --device cpu`` writes a checkpoint that
  ``Sampler(device="cpu")`` loads and samples from.
* The package's import walk covers the training modules.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ccsd_tpu.diffusion.losses import get_sde_loss_fn as jget_sde_loss_fn
from ccsd_tpu.diffusion.sde import load_sde as jload_sde
from ccsd_tpu.training.ema import ema_init
from ccsd_tpu.training.optim import make_optimizer as jmake_optimizer
from ccsd_tpu.training.trainer import Trainer as JTrainer

from ccsd_tpu_torch.training.ema import EMA
from ccsd_tpu_torch.training.trainer import Trainer
from ccsd_tpu_torch.utils.from_jax import load_jax_params, state_dict_from_jax

from test_torch_train_parity import SMALL, _t, batch, jax_draws, small_configs, small_networks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, F = 8, 5


def ring_adjs(num, seed=0):
    """``num`` rings of 4 to 8 nodes padded to N (degree 2 everywhere)."""
    rng = np.random.default_rng(seed)
    out = np.zeros((num, N, N), np.float32)
    for g in range(num):
        n = int(rng.integers(4, N + 1))
        i = np.arange(n)
        out[g, i, (i + 1) % n] = out[g, (i + 1) % n, i] = 1
    return out


def small_config(cfg, name="small", epochs=4, batch_size=4):
    cfg.train.name, cfg.train.num_epochs = name, epochs
    cfg.train.save_interval, cfg.train.print_interval = 2, 1
    cfg.train.lr_decay = 0.5  # a visible decay at each epoch boundary
    cfg.data.batch_size = batch_size
    return cfg


def test_three_trainer_steps_match_jax_train_step():
    jcfg, cfg, jms, ps, _ = small_networks(seed=4)
    small_config(cfg)
    for c in (jcfg, cfg):
        c.train.lr_decay = 0.5
    tc = jcfg.train
    # 10 graphs, 8 for training at batch 4: two steps an epoch on both sides
    trainer = Trainer(cfg, device="cpu", adjs=ring_adjs(10), log=False)
    assert len(trainer.train_loader) == 2
    for n, p in zip(("x", "adj"), ps):
        load_jax_params(trainer.models[n], p)
        trainer.emas[n] = EMA(trainer.models[n], tc.ema)

    jt = object.__new__(JTrainer)  # the JAX step, without JAX's data loading
    jt.names, jt.is_cc = ["x", "adj"], False
    jsdes = [jload_sde(jcfg.sde[n]) for n in ("x", "adj")]
    jt.loss_fn = jget_sde_loss_fn(*jsdes, *jms, reduce_mean=tc.reduce_mean, eps=tc.eps)
    opt = dict(lr=tc.lr, weight_decay=tc.weight_decay, grad_norm=tc.grad_norm,
               lr_schedule=tc.lr_schedule, lr_decay=tc.lr_decay, steps_per_epoch=2)
    jt.optimizers = {n: jmake_optimizer(**opt) for n in jt.names}
    step = jax.jit(jt._make_train_step())
    params = dict(zip(jt.names, ps))
    opts = {n: jt.optimizers[n].init(params[n]) for n in jt.names}
    emas = {n: ema_init(params[n], tc.ema) for n in jt.names}

    for k in range(3):
        x, adj = batch(k)
        key = jax.random.PRNGKey(100 + k)
        draws = [_t(d) for d in jax_draws(key, x, adj, jsdes[1], tc.eps)]
        params, opts, emas, jl = step(params, opts, emas, (jnp.asarray(x), jnp.asarray(adj)),
                                      key)
        trainer.loss_fn.draw = lambda x, adj, gen, d=draws: d
        losses = trainer.train_step(_t(x), _t(adj))
        np.testing.assert_allclose(losses.numpy(), np.asarray(jl), rtol=1e-4)

    tol = dict(rtol=1e-4, atol=1e-6)
    for n in jt.names:
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
        assert trainer.emas[n].num_updates == int(emas[n].num_updates) == 3


def _run(cfg_of, tmp_path, name, epochs, resume=None):
    cfg = small_config(cfg_of(), name=name, epochs=epochs)
    cfg.folder = str(tmp_path)
    t = Trainer(cfg, device="cpu", adjs=ring_adjs(12, seed=1))
    if resume:
        t.load_checkpoint(resume)
    t.train()
    return t


def test_resume_reproduces_the_uninterrupted_run_bit_for_bit(tmp_path):
    cfg_of = lambda: small_configs()[1]  # noqa: E731
    full = _run(cfg_of, tmp_path, "full", 4)
    half = _run(cfg_of, tmp_path, "half", 2)
    resumed = _run(cfg_of, tmp_path, "resumed", 4, resume=f"{half.ckpt_name}_final")
    assert resumed.epoch == full.epoch == 4 and resumed.step == full.step == 12
    assert resumed.history == full.history
    for n in ("x", "adj"):
        for (k, a), b in zip(full.models[n].state_dict().items(),
                             resumed.models[n].state_dict().values()):
            assert torch.equal(a, b), k
        for a, b in zip(full.emas[n].shadow_params, resumed.emas[n].shadow_params):
            assert torch.equal(a, b)
        sa, sb = (t.optimizers[n].adam.state_dict()["state"] for t in (full, resumed))
        for i in sa:
            for k in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(sa[i][k], sb[i][k]), (n, i, k)

    ckpt = torch.load(full.checkpoint_path(f"{full.ckpt_name}_final"), weights_only=True)
    for n in ("x", "adj"):
        assert {f"params_{n}", f"{n}_state_dict", f"ema_{n}", f"{n}_opt_state"} <= set(ckpt)
        assert set(ckpt[f"ema_{n}"]) == {"decay", "num_updates", "shadow_params"}
    assert ckpt["epoch"] == 4 and ckpt["step"] == 12 and "model_config" in ckpt
    # the mid-run checkpoint (save_interval 2) holds epoch 4 of the full run
    assert torch.load(full.checkpoint_path(full.ckpt_name), weights_only=True)["epoch"] == 4


TINY_YAML_EDITS = {"num_epochs: 5000": "num_epochs: 2", "save_interval: 5000": "save_interval: 1",
                   "print_interval: 500": "print_interval: 1", "batch_size: 128": "batch_size: 4",
                   "max_node_num: 20": f"max_node_num: {N}", "max_feat_num: 11":
                   f"max_feat_num: {F}", "num_scales: 1000": "num_scales: 5"}


def test_cli_train_writes_a_checkpoint_the_sampler_loads(tmp_path, capsys):
    from ccsd_tpu_torch import cli
    from ccsd_tpu_torch.sampling.sampler import Sampler
    from ccsd_tpu_torch.utils.config import get_config

    with open(os.path.join(ROOT, "config", "community_small.yaml")) as f:
        text = f.read()
    for a, b in TINY_YAML_EDITS.items():
        text = text.replace(a, b)
    for k, v in SMALL.items():
        text = text.replace(f"\n  {k}: ", f"\n  {k}: {v}  # was ", 1)
    os.makedirs(tmp_path / "config")
    (tmp_path / "config" / "tiny.yaml").write_text(text)
    np.save(tmp_path / "adjs.npy", ring_adjs(10))
    argv = ["--type", "train", "--config", "tiny", "--folder", str(tmp_path), "--device", "cpu",
            "--train-adjs", str(tmp_path / "adjs.npy"), "--seed", "3"]
    assert cli.main(argv) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["epochs"] == 2 and out["steps"] == 4 and out["device"] == "cpu"
    assert all(np.isfinite(out[k]) for k in ("train_loss_x", "train_loss_adj",
                                             "test_loss_x", "test_loss_adj", "steps_per_s"))
    ckpt = torch.load(out["ckpt_path"], weights_only=True)

    for use_ema in (False, True):
        cfg = get_config("tiny", 3, str(tmp_path))
        cfg.ckpt, cfg.sample.use_ema = out["ckpt"], use_ema
        sampler = Sampler(cfg, ring_adjs(10), device="cpu")
        _, models, source = sampler.load_models()
        assert source.startswith(out["ckpt_path"])
        for n in ("x", "adj"):
            want = (ckpt[f"ema_{n}"]["shadow_params"] if use_ema
                    else list(ckpt[f"{n}_state_dict"].values()))
            for p, w in zip(models[n].parameters(), want):
                assert torch.equal(p, w)
    res = sampler.sample(4)
    assert res["finite"] and res["adj"].shape == (4, N, N)

    # resuming continues from the saved epoch
    argv += ["--resume", out["ckpt"]]
    with open(tmp_path / "config" / "tiny.yaml") as f:
        (tmp_path / "config" / "tiny.yaml").write_text(
            f.read().replace("num_epochs: 2", "num_epochs: 3"))
    assert cli.main(argv) == 0
    again = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert again["epochs"] == 3 and again["steps"] == 6


def test_trainer_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(small_configs()[1], adjs=ring_adjs(4), log=False)


def test_import_walk_covers_the_training_modules():
    """tests/test_torch_package.py walks every module of the package; the
    training slice's are among them and import with jax, optax, flax and
    ccsd_tpu blocked."""
    import pkgutil

    import ccsd_tpu_torch

    mods = {m.name for m in pkgutil.walk_packages(ccsd_tpu_torch.__path__, "ccsd_tpu_torch.")}
    new = ["ccsd_tpu_torch.training.trainer", "ccsd_tpu_torch.training.optim",
           "ccsd_tpu_torch.training.ema", "ccsd_tpu_torch.training.checkpoint",
           "ccsd_tpu_torch.utils.logger", "ccsd_tpu_torch.diffusion.losses",
           "ccsd_tpu_torch.data.loader", "ccsd_tpu_torch.cli"]
    assert set(new) <= mods
    script = ("import importlib, sys\n"
              "for m in ('jax', 'jaxlib', 'optax', 'flax', 'ccsd_tpu'):\n"
              "    sys.modules[m] = None\n"
              f"for m in {new!r}:\n    importlib.import_module(m)\nprint('ok')\n")
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          cwd=ROOT, timeout=300, env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
