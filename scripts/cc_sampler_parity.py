"""The port's CC sampler against the JAX package's at full width, on the
CPU, from one trained checkpoint and one shared noise sequence.

Loads a port community_small_CC ``.pth`` into both packages (the JAX one
converts the reference-layout weights), runs ``--steps`` Euler + Langevin
steps of each package's CC PC sampler on B graphs' flags, feeding both the
same numpy noise in call order (priors, then per step the correctors' and
predictors' x, adjacency and rank-2 noise; the JAX sampler under
``jax.disable_jit()``), and prints the largest distance of each output from
the JAX one and how many entries quantize differently.

    JAX_PLATFORMS=cpu python3 scripts/cc_sampler_parity.py --ckpt PATH.pth \\
        [--steps 10] [--batch 4] [--fused]

Imports both packages: a diagnostic beside the tests, not part of the port.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", required=True, help="a port community_small_CC .pth")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--fused", action="store_true", help="both packages' fused networks")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import torch

    import ccsd_tpu.diffusion.solvers as jsolvers
    import ccsd_tpu_torch.diffusion.solvers as psolvers
    from ccsd_tpu.diffusion import sde as jsde
    from ccsd_tpu.diffusion.losses import get_score_fn_cc as jscore
    from ccsd_tpu.models.registry import load_model as jload
    from ccsd_tpu.models.registry import with_fused as jwith
    from ccsd_tpu.ops.cells import get_spec as jget_spec
    from ccsd_tpu.training.checkpoint import load_torch_reference_ckpt
    from ccsd_tpu_torch.data.loader import generated_adjs, init_flags
    from ccsd_tpu_torch.diffusion import sde as psde
    from ccsd_tpu_torch.diffusion.losses import get_score_fn_cc as pscore
    from ccsd_tpu_torch.models.registry import load_model as pload
    from ccsd_tpu_torch.models.registry import with_fused as pwith
    from ccsd_tpu_torch.ops.cells import get_spec
    from ccsd_tpu_torch.training.checkpoint import load_port_ckpt

    names = ("x", "adj", "rank2")
    jck = load_torch_reference_ckpt(args.ckpt, is_cc=True)
    pck = load_port_ckpt(args.ckpt, map_location="cpu")
    jdefs = {n: jck[f"params_{n}"] for n in names}
    pdefs = {n: pck[f"params_{n}"] for n in names}
    if args.fused:
        jdefs, pdefs = jwith(jdefs), pwith(pdefs)
    jms = {n: jload(jdefs[n]) for n in names}
    pms = {}
    for n in names:
        pms[n] = pload(pdefs[n]).eval()
        pms[n].load_state_dict(pck[f"{n}_state_dict"])

    d = pck["model_config"]["data"]
    B, N, F = args.batch, int(d["max_node_num"]), int(d["max_feat_num"])
    spec = get_spec(N, int(d["d_min"]), int(d["d_max"]))
    E, K = spec.num_edges, spec.num_cells
    adjs = generated_adjs("community_small_CC", 42, N)
    flags = init_flags(adjs[20:], B, np.random.default_rng(0))
    rng = np.random.default_rng(1)
    shapes = [(B, N, F), (B, N, N), (B, E, K)] * (1 + 2 * args.steps)
    seq = [rng.standard_normal(s).astype(np.float32) for s in shapes]

    def feed(wrap):
        it = iter(seq)

        def raw(shape):
            z = next(it)
            assert z.shape == tuple(shape)
            return wrap(z)

        return raw

    kw = dict(predictor="Euler", corrector="Langevin", snr=0.05, scale_eps=0.7, n_steps=1,
              probability_flow=False, denoise=True, eps=1e-4, is_cc=True)
    js = jsde.VPSDE(N=args.steps, beta_min=0.1, beta_max=1.0)
    jr = feed(jnp.asarray)

    def jgen(key, x, fl, sym=True):
        z = jr(x.shape)
        if sym:
            z = jnp.triu(z, 1)
            return jsolvers.mask_adjs(z + jnp.swapaxes(z, -1, -2), fl)
        return jsolvers.mask_x(z, fl)

    jsolvers.gen_noise = jgen
    jsolvers.gen_noise_rank2 = lambda key, x, sp, fl: jsolvers.mask_rank2(jr(x.shape), sp, fl)
    jsde.VPSDE.prior_sampling = lambda self, key, shape, dtype=None: jr(shape)
    jsde.VPSDE.prior_sampling_sym = lambda self, key, shape, dtype=None: (
        lambda z: z + jnp.swapaxes(z, -1, -2))(jnp.triu(jr(shape), 1))
    jsampler = jsolvers.get_pc_sampler(js, js, (B, N, F), (B, N, N), sde_rank2=js,
                                       shape_rank2=(B, E, K), spec=jget_spec(N, 3, 3), **kw)
    with jax.disable_jit():
        jout = jsampler(*[jscore(js, jms[n], jck[f"{n}_params"]) for n in names],
                        jnp.asarray(flags), jax.random.PRNGKey(0))

    ps = psde.VPSDE(N=args.steps, beta_min=0.1, beta_max=1.0)
    pr = feed(torch.from_numpy)

    def pgen(x, fl, sym=True, generator=None):
        z = pr(x.shape)
        if sym:
            z = torch.triu(z, 1)
            return psolvers.mask_adjs(z + z.transpose(-1, -2), fl)
        return psolvers.mask_x(z, fl)

    psolvers.gen_noise = pgen
    psolvers.gen_noise_rank2 = lambda x, sp, fl, generator=None: psolvers.mask_rank2(
        pr(x.shape), sp, fl)
    psde.VPSDE.prior_sampling = lambda self, shape, generator=None, device=None: pr(shape)
    psde.VPSDE.prior_sampling_sym = lambda self, shape, generator=None, device=None: (
        lambda z: z + z.transpose(-1, -2))(torch.triu(pr(shape), 1))
    psampler = psolvers.get_pc_sampler(ps, ps, (B, N, F), (B, N, N), sde_rank2=ps,
                                       shape_rank2=(B, E, K), spec=spec, **kw)
    with torch.no_grad():
        pout = psampler(*[pscore(ps, pms[n]) for n in names], torch.from_numpy(flags), None)
    for n in names:
        got, want = getattr(pout, n).numpy(), np.asarray(getattr(jout, n))
        print(json.dumps({"output": n, "steps": args.steps, "fused": args.fused,
                          "max_abs_diff": float(np.abs(got - want).max()),
                          "max_abs_ref": float(np.abs(want).max()),
                          "quantized_differ": int(((got >= 0.5) != (want >= 0.5)).sum()),
                          "entries": int(want.size)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
