"""Does the sampler stay finite with untrained weights?

Builds the port's seeded Glorot ScoreNetworkX/A (``ccsd_tpu_torch``),
scales the adjacency network's last layer, runs the config's 1000-step
sampler (community_small: Euler + Langevin; grid: Reverse + Langevin) and
prints, for each scale, the first step whose adjacency is not finite (None
when the run stays finite) and the largest |adjacency| before it.  With
``--jax`` (on the CPU) it also converts the same weights to the JAX package
with ``ccsd_tpu.utils.torch_convert`` and runs its sampler.

    JAX_PLATFORMS=cpu python scripts/random_weight_divergence.py --jax \
        [--batch 16] [--adj-head-scale 1.0] [--seed 0]
    python3 scripts/random_weight_divergence.py --config grid --device cuda \
        --batch 8 --adj-head-scale 1 0.1 0.01 [--fused]

chip_smoke.py uses ``--adj-head-scale 0.01`` for community_small's seeded
weights.  The Langevin corrector divides its step by the score's norm, so
a smaller head is not always tamer: its steps, and the noise they inject,
grow as the score shrinks.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ccsd_tpu_torch.data.loader import generated_adjs, init_flags, split  # noqa: E402
from ccsd_tpu_torch.diffusion import solvers as psolvers  # noqa: E402
from ccsd_tpu_torch.diffusion.losses import get_score_fn  # noqa: E402
from ccsd_tpu_torch.diffusion.sde import load_sde  # noqa: E402
from ccsd_tpu_torch.models.registry import load_model, load_model_params, with_fused  # noqa: E402
from ccsd_tpu_torch.utils.config import get_config  # noqa: E402


def networks(cfg, args, scale):
    """The seeded ScoreNetworkX and ScoreNetworkA, the latter's last layer
    scaled."""
    defs = dict(zip(("x", "adj"), load_model_params(cfg)))
    if args.fused:
        defs = with_fused(defs, True, fast=True)
    g = torch.Generator().manual_seed(args.seed)
    mx, ma = (load_model(defs[n], generator=g).eval() for n in ("x", "adj"))
    with torch.no_grad():
        ma.final.linears[-1].weight.mul_(scale)
    return mx, ma


def sampler_args(cfg, batch):
    """(flags of the train split, shapes, sampler keywords) of the config."""
    N, F = int(cfg.data.max_node_num), int(cfg.data.max_feat_num)
    adjs = generated_adjs(str(cfg.data.data), 0, N)
    flags = init_flags(adjs[split(len(adjs), float(cfg.data.test_split))[0]], batch,
                       np.random.default_rng(0))
    sc = cfg.sampler
    kw = dict(predictor=sc.predictor, corrector=sc.corrector, snr=sc.snr,
              scale_eps=sc.scale_eps, n_steps=sc.n_steps, denoise=True, eps=cfg.sample.eps)
    return flags, ((batch, N, F), (batch, N, N)), kw


def port_run(cfg, args, scale, device):
    """(first non-finite step or None, largest |adj| before it, output
    finite, seconds) of the port's sampler."""
    mx, ma = (m.to(device) for m in networks(cfg, args, scale))
    flags, shapes, kw = sampler_args(cfg, args.batch)
    sx, sa = load_sde(cfg.sde.x), load_sde(cfg.sde.adj)
    score_a, calls, first_bad, peak = get_score_fn(sa, ma), [0], [None], [0.0]

    def watched(x, adj, fl, t):
        calls[0] += 1
        if first_bad[0] is None:
            if torch.isfinite(adj).all():
                peak[0] = max(peak[0], adj.abs().max().item())
            else:
                first_bad[0] = (calls[0] - 1) // 2
        return score_a(x, adj, fl, t)

    t0 = time.perf_counter()
    with torch.no_grad():
        out = psolvers.get_pc_sampler(sx, sa, *shapes, **kw)(
            get_score_fn(sx, mx), watched, torch.from_numpy(flags).to(device),
            torch.Generator(device=device).manual_seed(12))
    finite = bool(torch.isfinite(out.adj).all() and torch.isfinite(out.x).all())
    return first_bad[0], peak[0], finite, time.perf_counter() - t0


def jax_run(cfg, args, scale):
    """The JAX package's sampler on the same weights, its own noise (CPU)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from ccsd_tpu.diffusion import solvers as jsolvers
    from ccsd_tpu.diffusion.losses import get_score_fn as jget_score_fn
    from ccsd_tpu.diffusion.sde import load_sde as jload_sde
    from ccsd_tpu.models.registry import load_model as jload_model
    from ccsd_tpu.models.registry import load_model_params as jload_model_params
    from ccsd_tpu.utils.config import get_config as jget_config
    from ccsd_tpu.utils.torch_convert import convert

    jcfg = jget_config(str(cfg.data.data), args.seed, ROOT)
    jm = [jload_model(d) for d in jload_model_params(jcfg)]
    params = [convert(j, {k: v.numpy() for k, v in m.state_dict().items()})
              for j, m in zip(jm, networks(cfg, args, scale))]
    flags, shapes, kw = sampler_args(cfg, args.batch)
    jx, ja = jload_sde(jcfg.sde.x), jload_sde(jcfg.sde.adj)
    sampler = jsolvers.get_pc_sampler(jx, ja, *shapes, record_trajectory=True, **kw)
    run = jax.jit(lambda fl, k: sampler(jget_score_fn(jx, jm[0], params[0]),
                                        jget_score_fn(ja, jm[1], params[1]), fl, k))
    jout = run(jnp.asarray(flags), jax.random.PRNGKey(12))
    traj = np.asarray(jout.trajectory[1])  # (steps, N, N): sample 0's adj means
    bad = np.where(~np.isfinite(traj).all(axis=(1, 2)))[0]
    print(f"jax:  first non-finite step of sample 0 {int(bad[0]) if len(bad) else None}, "
          f"output finite {bool(np.isfinite(jout.adj).all() and np.isfinite(jout.x).all())}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="community_small")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--adj-head-scale", type=float, nargs="+", default=[1.0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--fused", action="store_true", help="the fused fast network")
    ap.add_argument("--jax", action="store_true", help="also the JAX package, on the CPU")
    args = ap.parse_args()
    cfg = get_config(args.config, args.seed, ROOT)
    device = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    for scale in args.adj_head_scale:
        bad, peak, finite, secs = port_run(cfg, args, scale, device)
        print(f"port: config {args.config} B {args.batch} path "
              f"{'fused fast' if args.fused else 'unfused'} adjacency head x {scale}: first "
              f"non-finite step {bad}, largest |adj| before it {peak:.4e}, output finite "
              f"{finite}, {secs:.2f} s on {device}", flush=True)
        if args.jax:
            jax_run(cfg, args, scale)


if __name__ == "__main__":
    main()
