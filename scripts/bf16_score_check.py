"""Where the bf16 score networks leave f32 on a port checkpoint, and whether
the JAX package's bf16 score networks do the same on the same inputs.

Samples a CC checkpoint of the port with ``sample.score_dtype: bf16`` (on
the CPU; the default path, or ``sample.fused: false`` with ``--unfused``)
and keeps the sampler's inputs to one network
(``--network``: x, adj or rank2) at the score calls ``--calls`` (counted
over all three networks), or with ``--last K`` at that network's last K
calls before the sampler's first non-finite input to any network (the
whole run when there is none; the first such call is printed).  At each
kept state it evaluates that score
function four ways and prints each one's largest distance from a float64
copy of the same weights (the unfused form, which the fused one computes
in another order), beside the largest |score|:

* the port in f32 and in bf16 (``get_score_fn_cc(..., compute_dtype)``);
* the JAX package in f32 and in bf16 (``ccsd_tpu.diffusion.losses.
  get_score_fn_cc(..., compute_dtype=jnp.bfloat16)``, compiled), on the
  same weights carried across by ``ccsd_tpu.utils.torch_convert``.

    JAX_PLATFORMS=cpu python3 scripts/bf16_score_check.py \\
        --ckpt DIR/checkpoints/community_small_CC/NAME_final.pth \\
        [--config community_small_CC] [--network rank2] [--batch 16] \\
        [--calls 30 150 240 270 300 | --last 4] [--unfused]

A CPU diagnostic: it imports the JAX package beside the port (as the
tests do), so it does not run on the card's machine.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", required=True, help="a port checkpoint (.pth)")
    ap.add_argument("--config", default="community_small_CC")
    ap.add_argument("--network", default="rank2", choices=["x", "adj", "rank2"])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--calls", type=int, nargs="+", default=[30, 150, 240, 270, 300])
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--last", type=int, default=0,
                    help="keep the network's last K calls before the first non-finite input")
    ap.add_argument("--unfused", action="store_true", help="sample.fused: false")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from ccsd_tpu.diffusion.losses import get_score_fn_cc as jget_score_fn_cc
    from ccsd_tpu.diffusion.sde import load_sde as jload_sde
    from ccsd_tpu.models.registry import load_model as jload_model
    from ccsd_tpu.models.registry import with_fused as jwith_fused
    from ccsd_tpu.utils.torch_convert import convert

    import ccsd_tpu_torch.sampling.sampler as sampler_mod
    from ccsd_tpu_torch.data.loader import generated_adjs, split
    from ccsd_tpu_torch.diffusion.losses import get_score_fn_cc
    from ccsd_tpu_torch.diffusion.sde import load_sde
    from ccsd_tpu_torch.models.registry import load_model, load_model_params, with_fused
    from ccsd_tpu_torch.training.checkpoint import load_port_ckpt, state_dict_from_ckpt
    from ccsd_tpu_torch.utils.config import AttrDict, get_config

    cfg = AttrDict(get_config(args.config, args.seed, ROOT).to_dict())
    ckpt_dir = os.path.dirname(os.path.abspath(args.ckpt))
    cfg.folder = os.path.dirname(os.path.dirname(ckpt_dir))
    cfg.ckpt = os.path.basename(args.ckpt)[: -len(".pth")]
    cfg.sample.score_dtype, cfg.data.batch_size = "bf16", args.batch
    cfg.sample.fused = not args.unfused
    adjs = generated_adjs(str(cfg.data.data), args.seed, int(cfg.data.max_node_num))
    tr, te = split(len(adjs), float(cfg.data.test_split))

    # the sampler's inputs to the network at the asked calls
    names = {"x": "ScoreNetworkX", "adj": str(cfg.model.adj), "rank2": "ScoreNetworkF"}
    calls, kept, first_nonfinite = [0], {}, []
    real = sampler_mod.get_score_fn_cc

    class Done(Exception):
        pass

    def recording(sde, model, *dtypes):
        fn = real(sde, model, *dtypes)

        def run(*a):
            calls[0] += 1
            if args.last and not all(bool(v.isfinite().all()) for v in a):
                first_nonfinite.append(calls[0])
                raise Done
            ours = type(model).__name__ == names[args.network]
            if ours and (args.last or calls[0] in args.calls):
                kept[calls[0]] = [v.clone() for v in a]
                if args.last and len(kept) > args.last:
                    del kept[min(kept)]
            if not args.last and calls[0] >= max(args.calls):
                raise Done
            return fn(*a)
        return run

    sampler_mod.get_score_fn_cc = recording
    try:
        sampler_mod.Sampler(cfg, adjs[tr], adjs[te], device="cpu", log=False).sample(args.batch)
    except Done:
        pass
    finally:
        sampler_mod.get_score_fn_cc = real
    if args.last:
        print(json.dumps({"calls": calls[0], "first_nonfinite_call": (first_nonfinite or
                                                                      [None])[0]}), flush=True)

    i = ("x", "adj", "rank2").index(args.network)
    d = load_model_params(cfg)[i]
    ckpt = load_port_ckpt(args.ckpt, map_location="cpu")
    fd = d if args.unfused else with_fused({"n": d})["n"]
    model = load_model(fd).eval()
    model.load_state_dict(state_dict_from_ckpt(ckpt, args.network, model, False))
    ref_model = load_model(d)
    ref_model.load_state_dict(model.state_dict())
    ref_model = ref_model.double().eval()
    jmodel = jload_model(d if args.unfused else jwith_fused({"n": d})["n"])
    params = convert(jmodel, {k: v.numpy() for k, v in model.state_dict().items()})
    sde, jsde = load_sde(cfg.sde[args.network]), jload_sde(cfg.sde[args.network])
    jf32 = jax.jit(jget_score_fn_cc(jsde, jmodel, params))
    jbf16 = jax.jit(jget_score_fn_cc(jsde, jmodel, params, compute_dtype=jnp.bfloat16))
    for call, a in sorted(kept.items()):
        with torch.no_grad():
            ref = get_score_fn_cc(sde, ref_model)(*(v.double() for v in a)).numpy()
            port32 = get_score_fn_cc(sde, model)(*a).numpy()
            port16 = get_score_fn_cc(sde, model, torch.bfloat16)(*a).numpy()
        ja = [jnp.asarray(v.numpy()) for v in a]
        dist = lambda v: float(np.abs(np.asarray(v, np.float64) - ref).max())  # noqa: E731
        print(json.dumps({
            "call": call, "network": names[args.network], "t": float(a[-1][0]),
            "max_abs_rank2_in": float(a[2].abs().max()), "max_abs_score": float(np.abs(ref).max()),
            "distance_from_float64": {"port_f32": dist(port32), "port_bf16": dist(port16),
                                      "jax_f32": dist(jf32(*ja)), "jax_bf16": dist(jbf16(*ja))}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
