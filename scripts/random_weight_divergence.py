"""Does the community_small sampler stay finite with untrained weights?

Builds the port's seeded Glorot ScoreNetworkX/A (``ccsd_tpu_torch``),
optionally scales the adjacency network's last layer, converts the same
weights to the JAX package with ``ccsd_tpu.utils.torch_convert``, and runs
the 1000-step Euler + Langevin sampler of ``config/community_small.yaml`` in
both packages on the CPU.  Prints, per package, the first step whose
adjacency is not finite (None when the run stays finite).

    JAX_PLATFORMS=cpu python scripts/random_weight_divergence.py \
        [--batch 16] [--adj-head-scale 1.0] [--seed 0]

chip_smoke.py uses ``--adj-head-scale 0.01`` for its seeded weights.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from ccsd_tpu.diffusion import solvers as jsolvers  # noqa: E402
from ccsd_tpu.diffusion.losses import get_score_fn as jget_score_fn  # noqa: E402
from ccsd_tpu.diffusion.sde import load_sde as jload_sde  # noqa: E402
from ccsd_tpu.models.registry import load_model as jload_model  # noqa: E402
from ccsd_tpu.models.registry import load_model_params as jload_model_params  # noqa: E402
from ccsd_tpu.utils.config import get_config as jget_config  # noqa: E402
from ccsd_tpu.utils.torch_convert import convert  # noqa: E402
from ccsd_tpu_torch.data.loader import community_small_adjs, init_flags  # noqa: E402
from ccsd_tpu_torch.diffusion import solvers as psolvers  # noqa: E402
from ccsd_tpu_torch.diffusion.losses import get_score_fn  # noqa: E402
from ccsd_tpu_torch.diffusion.sde import load_sde  # noqa: E402
from ccsd_tpu_torch.models.registry import load_model, load_model_params  # noqa: E402
from ccsd_tpu_torch.utils.config import get_config  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--adj-head-scale", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    B = args.batch

    cfg = get_config("community_small", args.seed, ROOT)
    jcfg = jget_config("community_small", args.seed, ROOT)
    g = torch.Generator().manual_seed(args.seed)
    mx, ma = (load_model(d, generator=g).eval() for d in load_model_params(cfg))
    with torch.no_grad():
        ma.final.linears[-1].weight.mul_(args.adj_head_scale)
    flags = init_flags(community_small_adjs(100, 0), B,
                       np.random.default_rng(0))
    kw = dict(predictor="Euler", corrector="Langevin", snr=0.05, scale_eps=0.7,
              n_steps=1, denoise=True, eps=1e-4)
    shapes = (B, 20, 11), (B, 20, 20)

    # the port: count adjacency-score calls (2 per step) until one is not finite
    sx, sa = load_sde(cfg.sde.x), load_sde(cfg.sde.adj)
    score_a, calls, first_bad = get_score_fn(sa, ma), [0], [None]

    def watched(x, adj, fl, t):
        calls[0] += 1
        if first_bad[0] is None and not torch.isfinite(adj).all():
            first_bad[0] = (calls[0] - 1) // 2
        return score_a(x, adj, fl, t)

    out = psolvers.get_pc_sampler(sx, sa, *shapes, **kw)(
        get_score_fn(sx, mx), watched, torch.from_numpy(flags),
        torch.Generator().manual_seed(12))
    print(f"port: first non-finite step {first_bad[0]}, output finite "
          f"{bool(torch.isfinite(out.adj).all() and torch.isfinite(out.x).all())}")

    # the JAX package, same weights, its own noise
    jm = [jload_model(d) for d in jload_model_params(jcfg)]
    params = [convert(j, {k: v.numpy() for k, v in m.state_dict().items()})
              for j, m in zip(jm, (mx, ma))]
    jx, ja = jload_sde(jcfg.sde.x), jload_sde(jcfg.sde.adj)
    sampler = jsolvers.get_pc_sampler(jx, ja, *shapes, record_trajectory=True, **kw)
    run = jax.jit(lambda fl, k: sampler(jget_score_fn(jx, jm[0], params[0]),
                                        jget_score_fn(ja, jm[1], params[1]), fl, k))
    jout = run(jnp.asarray(flags), jax.random.PRNGKey(12))
    traj = np.asarray(jout.trajectory[1])  # (steps, N, N): sample 0's adj means
    bad = np.where(~np.isfinite(traj).all(axis=(1, 2)))[0]
    print(f"jax:  first non-finite step of sample 0 {int(bad[0]) if len(bad) else None}, "
          f"output finite {bool(np.isfinite(jout.adj).all() and np.isfinite(jout.x).all())}")


if __name__ == "__main__":
    main()
