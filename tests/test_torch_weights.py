"""Weights and configs carried from the JAX package into the port.

* A ``.ckpt.pkl`` written by ccsd_tpu's ``save_ckpt`` with the Trainer's
  payload (parameters, optax state, EMA state) is read by the port in a
  subprocess where jax, optax and ccsd_tpu cannot be imported; the score
  networks the port's ``Sampler`` builds from it must give the scores of
  the networks the JAX ``Sampler`` builds (``with_fused``), with
  ``sample.fast: false`` so that both are the f32 fused path (rtol = atol =
  1e-4, whole networks: see tests/test_torch_models.py; the bf16 scores of
  the fast path are held to JAX in tests/test_torch_fused_models.py).
* The port's YAML loader must equal ``yaml.safe_load`` on every config.
"""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import yaml

import jax
import jax.numpy as jnp

from ccsd_tpu.models.registry import load_model, load_model_params, with_fused
from ccsd_tpu.training.checkpoint import ckpt_path, save_ckpt
from ccsd_tpu.training.ema import ema_init, ema_update
from ccsd_tpu.training.optim import make_optimizer
from ccsd_tpu.utils.config import get_config

from ccsd_tpu_torch.utils.config import load_yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "config", "*.yaml")))
BLOCKED = ("jax", "jaxlib", "optax", "flax", "ccsd_tpu")

PORT_SCRIPT = r"""
import json, sys
for m in %(blocked)r:
    sys.modules[m] = None
import numpy as np, torch
from ccsd_tpu_torch.sampling.sampler import Sampler
from ccsd_tpu_torch.utils.config import AttrDict
args = json.loads(sys.argv[1])
cfg = AttrDict({"ckpt": "jax_run", "folder": args["folder"],
                "data": {"data": "community_small"},
                "sample": {"use_ema": args["use_ema"], "fast": False}})
_, models, _ = Sampler(cfg, np.zeros((1, 20, 20)), device="cpu").load_models()
inp = np.load(args["inputs"])
x, adj, flags = (torch.from_numpy(inp[k]) for k in ("x", "adj", "flags"))
with torch.no_grad():
    out = {n: models[n](x, adj, flags).numpy() for n in ("x", "adj")}
np.savez(args["out"], **out)
"""


def _perturb(tree, rng):
    return jax.tree.map(
        lambda a: a + jnp.asarray(rng.standard_normal(a.shape) * 0.05, a.dtype),
        tree)


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A checkpoint with the Trainer's payload layout (trainer.py:421-444)."""
    folder = str(tmp_path_factory.mktemp("run"))
    cfg = get_config("community_small", 0)
    defs = dict(zip(("x", "adj"), load_model_params(cfg)))
    rng = np.random.default_rng(0)
    payload, params = {"model_config": cfg.to_dict()}, {}
    opt = make_optimizer(lr=0.01, weight_decay=1e-4, grad_norm=1.0,
                         lr_schedule=True)
    for i, n in enumerate(("x", "adj")):
        p0 = load_model(defs[n]).init(jax.random.PRNGKey(i))
        p1 = _perturb(p0, rng)  # raw params moved away from the EMA shadow
        ema = ema_update(ema_init(p0), _perturb(p0, rng))
        payload.update({f"params_{n}": defs[n], f"{n}_params": p1,
                        f"{n}_opt_state": opt.init(p1), f"ema_{n}": ema})
        params[n] = {"raw": p1, "ema": ema.shadow_params}
    save_ckpt(ckpt_path(folder, "community_small", "jax_run"), payload)
    x = rng.standard_normal((3, 20, 11)).astype(np.float32)
    adj = np.triu((rng.random((3, 20, 20)) > 0.6).astype(np.float32), 1)
    adj = adj + adj.transpose(0, 2, 1)
    flags = np.ones((3, 20), np.float32)
    flags[1, 14:] = 0
    inputs = os.path.join(folder, "inputs.npz")
    np.savez(inputs, x=x, adj=adj, flags=flags)
    return folder, defs, params, (x, adj, flags), inputs


@pytest.mark.parametrize("use_ema", [False, True], ids=["raw", "ema"])
def test_jax_checkpoint_loads_without_jax(jax_checkpoint, tmp_path, use_ema):
    folder, defs, params, (x, adj, flags), inputs = jax_checkpoint
    out = str(tmp_path / "scores.npz")
    args = json.dumps({"folder": folder, "use_ema": use_ema, "inputs": inputs,
                       "out": out})
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", PORT_SCRIPT % {"blocked": BLOCKED}, args],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    got = np.load(out)
    for n, d in with_fused(defs, fast=False).items():
        p = params[n]["ema" if use_ema else "raw"]
        model = load_model(d)
        ref = jax.jit(lambda p, x, a, f: model.apply(p, x, a, flags=f))(
            p, jnp.asarray(x), jnp.asarray(adj), jnp.asarray(flags))
        np.testing.assert_allclose(got[n], np.asarray(ref), rtol=1e-4, atol=1e-4,
                                   err_msg=n)


@pytest.mark.parametrize("path", CONFIGS, ids=[os.path.basename(p) for p in CONFIGS])
def test_yaml_loader_matches_pyyaml(path):
    with open(path) as f:
        text = f.read()
    assert load_yaml(text) == yaml.safe_load(text)


def test_yaml_loader_scalars_and_collections():
    text = """
# comment
a: 1.0e-4   # YAML 1.1: a float needs the dot
b: 1e5
c: None
d: ~
e: [1, 2.5, x, 'q r']
f:
  - 1
  - k: v
    j: -2
g: {}
h: "quoted # not a comment"
i: yes
j:
"""
    assert load_yaml(text) == yaml.safe_load(text)
