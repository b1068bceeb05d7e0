"""The port's TwoStageTrainer and TwoStageSampler against the JAX package's,
on the CPU.

* One ``TwoStageTrainer`` step from the JAX parameters on the JAX draws
  (the graph loss's from one key, the F loss's from the other) against the
  JAX package's own jitted step: the training batch exactly, the three
  losses within rtol = 1e-5, and every parameter, Adam moment and EMA
  shadow of the three networks within rtol = atol = 1e-5.
* The trainer refuses a CC adjacency model and ``train.minibatch``, and a
  run resumed from its checkpoint ends bit for bit as the uninterrupted
  one.
* A JAX two-stage checkpoint loads into ``TwoStageSampler``: its three
  networks give the JAX networks' outputs (rtol = atol = 1e-5) and its
  ``k_max`` is the checkpoint's.
* ``TwoStageSampler``'s evaluation of generated CCs equals the JAX
  evaluation of the same CCs (the JAX sampler's calls), exactly.
* ``cli --type train`` and ``--type sample`` on a two-stage config, end to
  end at 3 steps: every generated CC is kept, the rank-2 entries sit in
  valid slots only, and both MMD sets are printed.

Sizes: N = 8 (E = 28), rings of 4 to 8 nodes with a chord, the networks
cut to a few narrow layers.
"""

import json

import networkx as nx
import numpy as np
import pytest
import yaml

import jax
import jax.numpy as jnp
import torch

import ccsd_tpu.training.two_stage_trainer as jtst
from ccsd_tpu.data import cc_codec as jcodec
from ccsd_tpu.diffusion import two_stage as jts
from ccsd_tpu.eval import cc_stats as jcc_stats
from ccsd_tpu.eval import stats as jstats
from ccsd_tpu.ops import masks as jmasks
from ccsd_tpu.training.ema import ema_init
from ccsd_tpu.utils.config import get_config as jget_config

from ccsd_tpu_torch import cli
from ccsd_tpu_torch.data.loader import community_small_adjs
from ccsd_tpu_torch.diffusion import two_stage as pts
from ccsd_tpu_torch.ops.cells import get_spec
from ccsd_tpu_torch.sampling.sampler import get_sampler_from_config, read_checkpoint
from ccsd_tpu_torch.sampling.two_stage_sampler import TwoStageSampler
from ccsd_tpu_torch.training.ema import EMA
from ccsd_tpu_torch.training.trainer import get_trainer_from_config
from ccsd_tpu_torch.training.two_stage_trainer import TwoStageTrainer
from ccsd_tpu_torch.utils.config import get_config
from ccsd_tpu_torch.utils.from_jax import load_jax_params, state_dict_from_jax

from test_torch_cc_models import _perturb, _t
from test_torch_cc_sampler import WORKER_KWARGS, ring_adjs, tame_rank2_head  # noqa: F401

NAMES = ("x", "adj", "rank2")
CONFIG = "community_small_CC_two_stage"
SMALL_TS = {"depth": 2, "nhid": 8, "num_layers": 2, "c_init": 2, "c_hid": 4, "c_final": 2,
            "adim": 8, "num_heads": 2, "nhid_h": 4, "num_layers_h": 1, "num_linears_h": 1,
            "c_hid_h": 2, "c_final_h": 2, "cnum": 2, "num_layers_mlp": 1}
TOL = dict(rtol=1e-5, atol=1e-5)


def ts_configs(epochs=1, steps=3):
    """(JAX config, port config) of community_small_CC_two_stage at N = 8
    and SMALL_TS widths."""
    out = []
    for get in (jget_config, get_config):
        c = get(CONFIG, 0)
        c.data.max_node_num, c.data.max_feat_num, c.data.batch_size = 8, 5, 4
        for k, v in SMALL_TS.items():
            c.model[k] = v
        c.train.name, c.train.num_epochs = "ts", epochs
        c.train.save_interval, c.train.print_interval = epochs, 1
        for n in NAMES:
            c.sde[n].num_scales = steps
        out.append(c)
    return out


def _jax_ccs(adjs):
    """The JAX package's CC dataset of the graphs (its generate_dataset lift)."""
    n = [int((a.sum(-1) > 0).sum()) for a in adjs]
    return jcodec.convert_graphs_to_CCs(
        [nx.from_numpy_array(a[:k, :k]) for a, k in zip(adjs, n)],
        lifting_procedure="path_based", lifting_procedure_kwargs="basic", max_nb_nodes=max(n))


def _jax_trainer(monkeypatch, jcfg, adjs):
    monkeypatch.setattr(jtst, "load_dataset", lambda d, name: _jax_ccs(adjs))
    return jtst.TwoStageTrainer(jcfg, log=False)


def test_one_two_stage_step_matches_the_jax_trainer(monkeypatch):
    jcfg, cfg = ts_configs()
    adjs = ring_adjs(10, 8)
    jt = _jax_trainer(monkeypatch, jcfg, adjs)
    trainer = get_trainer_from_config(cfg, device="cpu", adjs=adjs, log=False)
    assert isinstance(trainer, TwoStageTrainer) and trainer.k_max == jt.k_max
    jb = jt.train_batch
    for got, want in zip(trainer.batch, (jb["x"], jb["adj"], jb["rank2"], jb["dyn"].member,
                                         jb["dyn"].valid)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    tc = jcfg.train
    params = {n: _perturb(jt.params[n], 20 + i) for i, n in enumerate(NAMES)}
    opts = {n: jt.optimizers[n].init(params[n]) for n in NAMES}
    emas = {n: ema_init(params[n], tc.ema) for n in NAMES}
    for n in NAMES:
        load_jax_params(trainer.models[n], params[n])
        trainer.emas[n] = EMA(trainer.models[n], tc.ema)

    key = jax.random.PRNGKey(3)
    params, opts, emas, jl = jt._step(params, opts, emas, key)
    # the JAX draws: the graph loss's from k1 (losses.py:127-139), F's from
    # k2 (:287-293)
    k1, k2 = jax.random.split(key)
    x, adj, r2 = (jnp.asarray(b.numpy()) for b in trainer.batch[:3])
    flags, eps = jmasks.node_flags(adj), tc.eps
    k_t, k_zx, k_zadj = jax.random.split(k1, 3)
    t = jax.random.uniform(k_t, (adj.shape[0],)) * (1.0 - eps) + eps
    graph_draws = [t, jmasks.gen_noise(k_zx, x, flags, sym=False),
                   jmasks.gen_noise(k_zadj, adj, flags, sym=True)]
    k_t, k_z = jax.random.split(k2)
    t = jax.random.uniform(k_t, (adj.shape[0],)) * (1.0 - eps) + eps
    f_draws = [t, jmasks.gen_noise_rank2_dynamic(k_z, r2, jt.spec, jb["dyn"].member,
                                                 jb["dyn"].valid, flags)]
    trainer.loss_graph.draw = lambda *a: [_t(d) for d in graph_draws]
    trainer.loss_rank2.draw = lambda *a: [_t(d) for d in f_draws]
    got = trainer.train_step()
    np.testing.assert_allclose(got.numpy(), np.asarray(jl), rtol=1e-5)

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
                                           err_msg=f"{n} {name} {what}", **TOL)


@pytest.mark.parametrize("change,error,match", [
    ({"model": {"adj": "ScoreNetworkA_CC"}}, ValueError, "graph model"),
    ({"train": {"minibatch": 4}}, NotImplementedError, "minibatch"),
    ({"is_cc": False}, ValueError, "CC config")])
def test_trainer_refuses_what_it_does_not_train(change, error, match):
    cfg = ts_configs()[1]
    for k, v in change.items():
        if isinstance(v, dict):
            cfg[k].update(v)
        else:
            cfg[k] = v
    with pytest.raises(error, match=match):
        TwoStageTrainer(cfg, device="cpu", adjs=ring_adjs(10, 8), log=False)


def test_a_jax_two_stage_checkpoint_loads_into_the_sampler(monkeypatch, tmp_path):
    jcfg, cfg = ts_configs()
    jcfg.folder = str(tmp_path)
    adjs = ring_adjs(10, 8)
    jt = _jax_trainer(monkeypatch, jcfg, adjs)
    jt.params = {n: _perturb(jt.params[n], 30 + i) for i, n in enumerate(NAMES)}
    jt.save_checkpoint(suffix="_final")
    cfg.folder, cfg.ckpt, cfg.sample.fused = str(tmp_path), "ckpt_final", False
    sampler = get_sampler_from_config(cfg, adjs[2:], adjs[:2], device="cpu", log=False)
    assert isinstance(sampler, TwoStageSampler)
    _, models, source = sampler.load_models()
    assert source.endswith("(raw params)") and read_checkpoint(cfg)[0]["k_max"] == jt.k_max
    x, adj, rank2, member, valid = (jnp.asarray(np.asarray(v)) for v in (
        jt.train_batch["x"], jt.train_batch["adj"], jt.train_batch["rank2"],
        jt.train_batch["dyn"].member, jt.train_batch["dyn"].valid))
    flags = jmasks.node_flags(adj)
    wants = [jt.models["x"].apply(jt.params["x"], x, adj, flags=flags),
             jt.models["adj"].apply(jt.params["adj"], x, adj, flags=flags),
             jt.models["rank2"].apply(jt.params["rank2"], None, None, rank2, flags=flags,
                                      dyn=(member, valid))]
    with torch.no_grad():
        tx, tadj, tr2, tm, tv, tfl = (_t(v) for v in (x, adj, rank2, member, valid, flags))
        gots = [models["x"](tx, tadj, tfl), models["adj"](tx, tadj, tfl),
                models["rank2"](None, None, tr2, flags=tfl, dyn=(tm, tv))]
    for n, got, want in zip(NAMES, gots, wants):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=n, **TOL)


@pytest.mark.parametrize("seed", [0, 42])
def test_sampler_evaluation_matches_jax(seed):
    """The generated CCs of the bridge and the decoder (graphs of another
    seed with nodes cut off, rank-2 entries drawn in valid slots) scored
    as the JAX two-stage sampler scores them: ``eval_graph_list`` of the
    1-skeletons and ``eval_CC_list``, against the test split's lift."""
    test = community_small_adjs(100, seed)[:20]
    gen = community_small_adjs(20, seed + 1)
    rng = np.random.default_rng(seed)
    for g in gen:
        cut = rng.integers(0, 20, 2)
        g[cut] = 0
        g[:, cut] = 0
    spec = get_spec(20, 3, 3)
    dyn = pts.dynamic_cells_from_adjs(gen, 3, 3, None, lifting_procedure="path_based",
                                      path_length=3)
    rank2_q = ((rng.random((20, spec.num_edges, dyn.k_max)) < 0.01)
               * dyn.valid.numpy()[:, None, :]).astype(np.uint8)
    x = np.ones((20, 20, 4), np.float32)
    jdyn = jts.DynamicCells(jnp.asarray(dyn.member.numpy()), jnp.asarray(dyn.valid.numpy()),
                            dyn.cell_lists)
    ccs = pts.ccs_from_two_stage(x, gen, rank2_q, dyn, spec)
    jccs = jts.ccs_from_two_stage(x, gen, rank2_q, jdyn, spec)
    jtest = _jax_ccs(test)
    methods, kernels = jstats.load_eval_settings()
    want_mmd = jstats.eval_graph_list(jcodec.convert_CC_to_graphs(jtest),
                                      jcodec.convert_CC_to_graphs(jccs), methods=methods,
                                      kernels=kernels)
    want_cc = jcc_stats.eval_CC_list(jtest, jccs, WORKER_KWARGS, cc_nb_eval=1000)
    cfg = get_config(CONFIG, seed)
    sampler = TwoStageSampler(cfg, test, test, device="cpu", log=False)
    got = sampler.evaluate_ccs(test, ccs, spec)
    assert got["mmd"] == want_mmd and got["cc_mmd"] == want_cc
    cfg.sample.cc_eval_max_cells = spec.num_cells - 1  # the gate: counts instead
    counts = sampler.evaluate_ccs(test, ccs, spec)
    assert counts["mmd"] == want_mmd and counts["cc_mmd"] is None
    assert counts["rank2_counts"]["gen_mean"] == np.mean(
        [len(c.cells.hyperedge_dict.get(2, {})) for c in jccs])


def test_cli_trains_and_samples_a_two_stage_config(tmp_path, capsys, tame_rank2_head):  # noqa: F811
    (tmp_path / "config").mkdir()
    cfg = ts_configs(epochs=2)[1].to_dict()
    with open(tmp_path / "config" / "tiny_ts.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    np.save(tmp_path / "adjs.npy", ring_adjs(10, 8))
    common = ["--config", "tiny_ts", "--folder", str(tmp_path), "--device", "cpu",
              "--train-adjs", str(tmp_path / "adjs.npy")]
    assert cli.main(["--type", "train", *common]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["epochs"] == report["steps"] == 2 and np.isfinite(report["train_loss_rank2"])
    assert "test_loss_x" not in report
    assert cli.main(["--type", "sample", *common, "--ckpt", report["ckpt"]]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    # one round of data.batch_size = 4 for a test split of 2: all 4 kept
    assert report["samples"] == 4 and report["finite"] and len(report["k_max"]) == 1
    assert set(report["mmd"]) == {"degree", "cluster", "orbit", "spectral"}
    assert set(report["cc_mmd"]) >= {"hodge_laplacian_spectrum"}
    assert report["stage1_steps_per_s"] > 0 and report["stage2_steps_per_s"] > 0
    assert report["finite_stages"] == {"stage1": True, "stage2": True}
    assert report["stage2_finite_steps"] == cfg["sde"]["rank2"]["num_scales"]
    assert 0 < report["stage2_max_abs"] < np.inf


def test_sampler_keeps_rank2_in_valid_slots(tmp_path, tame_rank2_head):  # noqa: F811
    cfg = ts_configs(steps=3)[1]
    cfg.folder = str(tmp_path)
    adjs = ring_adjs(10, 8)
    res = TwoStageSampler(cfg, adjs[2:], adjs[:2], device="cpu", log=False).sample()
    assert len(res["ccs"]) == 4 and res["adj"].shape == (4, 8, 8) and res["finite"]
    (rank2,), (valid,) = res["rank2_rounds"], res["valid_rounds"]
    assert rank2.shape == (4, 28, res["k_max"][0]) and rank2.dtype == np.uint8
    assert not rank2.transpose(0, 2, 1)[valid == 0].any()
    cells = [len(c.cells.hyperedge_dict.get(2, {})) for c in res["ccs"]]
    assert res["cells_per_cc"] == np.mean(cells) == rank2.any(1).sum(1).mean()


def test_two_stage_resume_reproduces_the_uninterrupted_run(tmp_path):
    def run(name, epochs, resume=None):
        cfg = ts_configs(epochs=epochs)[1]
        cfg.folder, cfg.train.name = str(tmp_path), name
        t = TwoStageTrainer(cfg, device="cpu", adjs=ring_adjs(10, 8, seed=2), log=False)
        if resume:
            t.load_checkpoint(resume)
        t.train()
        return t

    full, half = run("full", 3), run("half", 2)
    resumed = run("resumed", 3, resume=f"{half.ckpt_name}_final")
    assert resumed.epoch == full.epoch == 3 and resumed.history == full.history
    for n in NAMES:
        for (k, a), b in zip(full.models[n].state_dict().items(),
                             resumed.models[n].state_dict().values()):
            assert torch.equal(a, b), f"{n}.{k}"
        for a, b in zip(full.emas[n].shadow_params, resumed.emas[n].shadow_params):
            assert torch.equal(a, b)
