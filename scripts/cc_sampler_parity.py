"""The port's CC sampler against the JAX package's at full width, from one
trained checkpoint and one shared noise sequence.

Loads a port community_small_CC ``.pth`` into both packages (the JAX one
converts the reference-layout weights), runs ``--steps`` Euler + Langevin
steps of each package's CC PC sampler on B graphs' flags, feeding both the
same numpy noise in call order (``np.random.default_rng(1)``: the priors,
then per step the correctors' and predictors' x, adjacency and rank-2
noise; the JAX sampler's loop under ``jax.disable_jit()``, its score
networks jitted), and prints the largest
distance of each output from the JAX one and how many entries quantize
differently.  Every score evaluation is recorded: the L2 norm of each
sample's state going in and of the score coming out, so the first step at
which the two runs part, and the network that parts first, can be read
off (``first_parted``).

    JAX_PLATFORMS=cpu python3 scripts/cc_sampler_parity.py --ckpt PATH.pth \\
        [--steps 10] [--batch 4] [--fused]

The two packages may run on different machines: ``--side port --record
FILE.npz [--device cuda]`` runs the port alone (the card's machine has no
JAX) and writes its outputs and record; ``--side jax --compare FILE.npz``
then runs the JAX package on the CPU with the same arguments and compares.
Imports JAX only on the JAX side: a diagnostic beside the tests, not part
of the port.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

NAMES = ("x", "adj", "rank2")
KW = dict(predictor="Euler", corrector="Langevin", snr=0.05, scale_eps=0.7, n_steps=1,
          probability_flow=False, denoise=True, eps=1e-4, is_cc=True)
# relative distance of a recorded norm at which the two runs count as parted
PART_REL = 1e-3


class Noise:
    """The shared noise: draws in call order from one seeded generator, each
    checked against the shape its caller asks for."""

    def __init__(self, wrap):
        self.rng, self.wrap = np.random.default_rng(1), wrap

    def __call__(self, shape):
        return self.wrap(self.rng.standard_normal(tuple(shape)).astype(np.float32))


def host(a) -> np.ndarray:
    """A torch tensor (on any device) or JAX array as float64 numpy."""
    a = a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)
    return a.astype(np.float64)


def recorder(fns, log):
    """Score functions that log, per call, each sample's norm of the state
    they update (x: argument 0, adjacency: 1, rank-2: 2) and of their
    output."""
    def wrap(i, fn):
        def f(*args):
            out = fn(*args)
            v = [host(args[i]), host(out)]
            log[NAMES[i]].append([np.sqrt((a.reshape(a.shape[0], -1) ** 2).sum(1)) for a in v])
            return out
        return f
    return [wrap(i, fn) for i, fn in enumerate(fns)]


def setting(ckpt, batch):
    """(B, N, F, E, K, flags) of the run: B graphs' flags drawn from the
    dataset's train split."""
    from ccsd_tpu_torch.data.loader import generated_adjs, init_flags
    from ccsd_tpu_torch.ops.cells import get_spec

    d = ckpt["model_config"]["data"]
    N, F = int(d["max_node_num"]), int(d["max_feat_num"])
    spec = get_spec(N, int(d["d_min"]), int(d["d_max"]))
    adjs = generated_adjs("community_small_CC", 42, N)
    flags = init_flags(adjs[20:], batch, np.random.default_rng(0))
    return batch, N, F, spec, flags


def run_port(args):
    import torch

    import ccsd_tpu_torch.diffusion.solvers as psolvers
    from ccsd_tpu_torch.diffusion import sde as psde
    from ccsd_tpu_torch.diffusion.losses import get_score_fn_cc as pscore
    from ccsd_tpu_torch.models.registry import load_model as pload
    from ccsd_tpu_torch.models.registry import with_fused as pwith
    from ccsd_tpu_torch.training.checkpoint import load_port_ckpt

    dev = torch.device(args.device)
    pck = load_port_ckpt(args.ckpt, map_location="cpu")
    B, N, F, spec, flags = setting(pck, args.batch)
    defs = {n: pck[f"params_{n}"] for n in NAMES}
    if args.fused:
        defs = pwith(defs)
    pms = {}
    for n in NAMES:
        pms[n] = pload(defs[n]).eval()
        pms[n].load_state_dict(pck[f"{n}_state_dict"])
        pms[n].to(dev)
    noise = Noise(lambda z: torch.from_numpy(z).to(dev))

    def gen(x, fl, sym=True, generator=None):
        z = noise(x.shape)
        if sym:
            z = torch.triu(z, 1)
            return psolvers.mask_adjs(z + z.transpose(-1, -2), fl)
        return psolvers.mask_x(z, fl)

    psolvers.gen_noise = gen
    psolvers.gen_noise_rank2 = lambda x, sp, fl, generator=None: psolvers.mask_rank2(
        noise(x.shape), sp, fl)
    psde.VPSDE.prior_sampling = lambda self, shape, generator=None, device=None: noise(shape)
    psde.VPSDE.prior_sampling_sym = lambda self, shape, generator=None, device=None: (
        lambda z: z + z.transpose(-1, -2))(torch.triu(noise(shape), 1))
    ps = psde.VPSDE(N=args.steps, beta_min=0.1, beta_max=1.0)
    sampler = psolvers.get_pc_sampler(ps, ps, (B, N, F), (B, N, N), sde_rank2=ps,
                                      shape_rank2=(B, spec.num_edges, spec.num_cells),
                                      spec=spec, **KW)
    log = {n: [] for n in NAMES}
    fns = recorder([pscore(ps, pms[n]) for n in NAMES], log)
    with torch.no_grad():
        out = sampler(*fns, torch.from_numpy(flags).to(dev), None)
    return {n: getattr(out, n).cpu().numpy() for n in NAMES}, log


def run_jax(args):
    import jax
    import jax.numpy as jnp

    import ccsd_tpu.diffusion.solvers as jsolvers
    from ccsd_tpu.diffusion import sde as jsde
    from ccsd_tpu.diffusion.losses import get_score_fn_cc as jscore
    from ccsd_tpu.models.registry import load_model as jload
    from ccsd_tpu.models.registry import with_fused as jwith
    from ccsd_tpu.ops.cells import get_spec as jget_spec
    from ccsd_tpu.training.checkpoint import load_torch_reference_ckpt
    from ccsd_tpu_torch.training.checkpoint import load_port_ckpt

    jck = load_torch_reference_ckpt(args.ckpt, is_cc=True)
    B, N, F, spec, flags = setting(load_port_ckpt(args.ckpt, map_location="cpu"), args.batch)
    defs = {n: jck[f"params_{n}"] for n in NAMES}
    if args.fused:
        defs = jwith(defs)
    jms = {n: jload(defs[n]) for n in NAMES}
    noise = Noise(jnp.asarray)

    def gen(key, x, fl, sym=True):
        z = noise(x.shape)
        if sym:
            z = jnp.triu(z, 1)
            return jsolvers.mask_adjs(z + jnp.swapaxes(z, -1, -2), fl)
        return jsolvers.mask_x(z, fl)

    jsolvers.gen_noise = gen
    jsolvers.gen_noise_rank2 = lambda key, x, sp, fl: jsolvers.mask_rank2(noise(x.shape), sp, fl)
    jsde.VPSDE.prior_sampling = lambda self, key, shape, dtype=None: noise(shape)
    jsde.VPSDE.prior_sampling_sym = lambda self, key, shape, dtype=None: (
        lambda z: z + jnp.swapaxes(z, -1, -2))(jnp.triu(noise(shape), 1))
    js = jsde.VPSDE(N=args.steps, beta_min=0.1, beta_max=1.0)
    sampler = jsolvers.get_pc_sampler(js, js, (B, N, F), (B, N, N), sde_rank2=js,
                                      shape_rank2=(B, spec.num_edges, spec.num_cells),
                                      spec=jget_spec(N, spec.d_min, spec.d_max), **KW)
    def compiled(fn):  # the networks jitted, as the JAX sampler runs them
        jitted = jax.jit(fn)

        def f(*a):
            with jax.disable_jit(False):
                return jitted(*a)
        return f

    log = {n: [] for n in NAMES}
    fns = recorder([compiled(jscore(js, jms[n], jck[f"{n}_params"])) for n in NAMES], log)
    with jax.disable_jit():
        out = sampler(*fns, jnp.asarray(flags), jax.random.PRNGKey(0))
    return {n: np.asarray(getattr(out, n)) for n in NAMES}, log


def first_parted(got_log, want_log):
    """(call, sample, 'state' or 'score') of each network's first recorded
    norm more than PART_REL apart, relative, or None; two score
    evaluations a step."""
    out = {}
    for n in NAMES:
        out[n] = None
        for call, (g, w) in enumerate(zip(got_log[n], want_log[n])):
            for what, a, b in (("state", g[0], w[0]), ("score", g[1], w[1])):
                rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-12)
                rel = np.where(np.isnan(a) != np.isnan(b), np.inf, rel)
                if (rel > PART_REL).any():
                    out[n] = {"call": call, "step": call // 2, "what": what,
                              "sample": int(np.argmax(rel)), "rel": float(rel.max())}
                    break
            if out[n]:
                break
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", required=True, help="a port community_small_CC .pth")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--fused", action="store_true", help="both packages' fused networks")
    ap.add_argument("--side", choices=["both", "port", "jax"], default="both")
    ap.add_argument("--record", default=None, help="port side: write outputs and record here")
    ap.add_argument("--compare", default=None, help="jax side: the port side's record")
    ap.add_argument("--device", default="cpu", help="port side's device")
    args = ap.parse_args(argv)
    meta = {"steps": args.steps, "batch": args.batch, "fused": args.fused}

    if args.side == "port":
        if not args.record:
            ap.error("--side port needs --record FILE.npz")
        got, log = run_port(args)
        arrays = {f"out_{n}": v for n, v in got.items()}
        for n in NAMES:
            arrays[f"log_{n}"] = np.asarray(log[n])  # (calls, 2, B)
        os.makedirs(os.path.dirname(os.path.abspath(args.record)), exist_ok=True)
        np.savez(args.record, meta=json.dumps(meta), **arrays)
        print(json.dumps({"side": "port", "device": args.device, "record": args.record,
                          **meta}))
        return 0
    if args.side == "jax":
        if not args.compare:
            ap.error("--side jax needs --compare FILE.npz")
        rec = np.load(args.compare)
        if json.loads(str(rec["meta"])) != meta:
            raise SystemExit(f"the record was made with {rec['meta']}, here {meta}")
        got = {n: rec[f"out_{n}"] for n in NAMES}
        got_log = {n: list(rec[f"log_{n}"]) for n in NAMES}
    else:
        got, got_log = run_port(args)
    want, want_log = run_jax(args)
    for n in NAMES:
        g, w = got[n], want[n]
        print(json.dumps({"output": n, **meta, "max_abs_diff": float(np.abs(g - w).max()),
                          "max_abs_ref": float(np.abs(w).max()),
                          "quantized_differ": int(((g >= 0.5) != (w >= 0.5)).sum()),
                          "entries": int(w.size)}), flush=True)
    print(json.dumps({"first_parted": first_parted(got_log, want_log), "part_rel": PART_REL,
                      **meta}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
