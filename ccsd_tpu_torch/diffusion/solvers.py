"""Predictor-corrector reverse-diffusion sampler, graph mode.

Port of the graph branch of ccsd_tpu/diffusion/solvers.py:56-145 and
:193-298.  The JAX ``lax.scan`` becomes a Python loop over
``torch.linspace(T, eps, N)``; noise comes from one ``torch.Generator``.
Semantics kept exactly:

  * corrector then predictor in each step; the adjacency update sees the
    pre-update ``_x`` (solvers.py:267-281);
  * Euler-Maruyama and reverse-diffusion predictors; Langevin and None
    correctors;
  * the Langevin step size couples the batch through the batch mean of
    per-sample L2 norms, accumulated in f32 (solvers.py:56-74);
  * with ``denoise`` the sampler returns the last step's means.

Noise is drawn in the JAX package's call order (corrector x, corrector adj,
predictor x, predictor adj), so a test that feeds both packages one noise
sequence compares like with like.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Sequence

import torch

from ccsd_tpu_torch.diffusion.sde import SDE, _bcast, reverse_discretize, reverse_sde
from ccsd_tpu_torch.ops.masks import gen_noise, mask_adjs, mask_x


class SamplerOutput(NamedTuple):
    x: torch.Tensor
    adj: torch.Tensor
    n_model_evals: int


def _batch_norm_mean(v: torch.Tensor) -> torch.Tensor:
    """Mean over the batch of per-sample L2 norms, in f32."""
    v = v.to(torch.float32)
    return torch.linalg.vector_norm(v.reshape(v.shape[0], -1), dim=-1).mean()


def _langevin_step(sde: SDE, score, v, noise, t, snr, scale_eps):
    """One Langevin MCMC correction of tensor v given its score and noise."""
    alpha = sde.alpha_of_t(t)
    grad_norm = _batch_norm_mean(score)
    noise_norm = _batch_norm_mean(noise)
    step_size = (snr * noise_norm / grad_norm) ** 2 * 2 * alpha
    v_mean = v + _bcast(step_size, v).to(v.dtype) * score
    v = v_mean + _bcast(torch.sqrt(step_size * 2), v).to(v.dtype) * noise * scale_eps
    return v, v_mean


def _noise_for(obj: str, v, flags, generator):
    return gen_noise(v, flags, sym=(obj == "adj"), generator=generator)


def _make_corrector(corrector: str, obj: str, sde: SDE, snr, scale_eps,
                    n_steps: int):
    """(generator, score_eval, v, flags, t) -> (v, v_mean)."""
    if corrector == "None":
        return lambda generator, score_eval, v, flags, t: (v, v)
    if corrector != "Langevin":
        raise NotImplementedError(
            f"Corrector {corrector} not supported. Select from [Langevin, None]."
        )

    def update(generator, score_eval, v, flags, t):
        v_mean = v
        for _ in range(n_steps):
            score = score_eval(v)
            noise = _noise_for(obj, v, flags, generator)
            v, v_mean = _langevin_step(sde, score, v, noise, t, snr, scale_eps)
        return v, v_mean

    return update


def _make_predictor(predictor: str, obj: str, sde: SDE, probability_flow: bool):
    """(generator, score_eval, v, flags, t) -> (v, v_mean)."""
    if predictor == "Euler":
        rev = reverse_sde(sde, probability_flow)

        def update(generator, score_eval, v, flags, t):
            dt = -1.0 / sde.N
            z = _noise_for(obj, v, flags, generator)
            drift, diffusion = rev(v, t, score_eval(v))
            v_mean = v + drift * dt
            return v_mean + _bcast(diffusion, v) * math.sqrt(-dt) * z, v_mean

        return update
    if predictor == "Reverse":
        rev = reverse_discretize(sde, probability_flow)

        def update(generator, score_eval, v, flags, t):
            f, G = rev(v, t, score_eval(v))
            z = _noise_for(obj, v, flags, generator)
            v_mean = v - f
            return v_mean + _bcast(G, v) * z, v_mean

        return update
    raise NotImplementedError(
        f"Predictor {predictor} not supported. Select from [Reverse, Euler]."
    )


def get_pc_sampler(
    sde_x: SDE,
    sde_adj: SDE,
    shape_x: Sequence[int],
    shape_adj: Sequence[int],
    predictor: str = "Euler",
    corrector: str = "None",
    snr: float = 0.1,
    scale_eps: float = 1.0,
    n_steps: int = 1,
    probability_flow: bool = False,
    denoise: bool = True,
    eps: float = 1e-3,
) -> Callable:
    """Build ``sampler(score_fn_x, score_fn_adj, init_flags, generator)``.

    Everything runs on the device of ``init_flags`` and of the generator.
    """
    shape_x, shape_adj = tuple(shape_x), tuple(shape_adj)
    diff_steps = sde_adj.N
    corr_x = _make_corrector(corrector, "x", sde_x, snr, scale_eps, n_steps)
    corr_adj = _make_corrector(corrector, "adj", sde_adj, snr, scale_eps, n_steps)
    pred_x = _make_predictor(predictor, "x", sde_x, probability_flow)
    pred_adj = _make_predictor(predictor, "adj", sde_adj, probability_flow)

    @torch.no_grad()
    def sampler(score_fn_x, score_fn_adj, init_flags: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> SamplerOutput:
        flags = init_flags
        dev = flags.device
        x = mask_x(sde_x.prior_sampling(shape_x, generator, dev), flags)
        adj = mask_adjs(sde_adj.prior_sampling_sym(shape_adj, generator, dev), flags)
        timesteps = torch.linspace(sde_adj.T, eps, diff_steps, device=dev)
        x_mean, adj_mean = x, adj
        for i in range(diff_steps):
            vec_t = timesteps[i].expand(shape_adj[0])

            _x = x
            x, _ = corr_x(generator, lambda v: score_fn_x(v, adj, flags, vec_t),
                          x, flags, vec_t)
            adj, _ = corr_adj(generator, lambda v: score_fn_adj(_x, v, flags, vec_t),
                              adj, flags, vec_t)

            _x = x
            x, x_mean = pred_x(generator, lambda v: score_fn_x(v, adj, flags, vec_t),
                               x, flags, vec_t)
            adj, adj_mean = pred_adj(
                generator, lambda v: score_fn_adj(_x, v, flags, vec_t),
                adj, flags, vec_t)
        return SamplerOutput(
            x=x_mean if denoise else x,
            adj=adj_mean if denoise else adj,
            n_model_evals=diff_steps * (n_steps + 1),
        )

    return sampler
