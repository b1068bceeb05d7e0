"""Predictor-corrector and S4 reverse-diffusion samplers, graph and CC mode.

Port of ccsd_tpu/diffusion/solvers.py:56-145, :193-360 (the graph and the
CC branch of ``get_pc_sampler``) and :366-500 (``get_s4_solver``).  The JAX
``lax.scan`` becomes a Python loop over
``torch.linspace(T, eps, N)``; noise comes from one ``torch.Generator``.
Semantics kept exactly:

  * corrector then predictor in each step; the adjacency update sees the
    pre-update ``_x`` (solvers.py:267-281); in CC mode the rank-2 update
    sees the pre-update x and adjacency, and x's sees the current
    adjacency and rank-2 tensor (:314-345);
  * Euler-Maruyama and reverse-diffusion predictors; Langevin and None
    correctors;
  * the Langevin step size couples the batch through the batch mean of
    per-sample L2 norms, accumulated in f32 (solvers.py:56-74);
  * with ``denoise`` the sampler returns the last step's means.

Noise is drawn in the JAX package's call order (corrector x, corrector adj
[, corrector rank2], predictor x, predictor adj [, predictor rank2]; the S4
predictor draws twice, once for each half-step transition), so a test that
feeds both packages one noise sequence compares like with like.
The rank-2 noise and prior are masked by ``mask_rank2`` and not
symmetrised.

``carry_dtype=torch.bfloat16`` (``sample.dtype: bf16``; solvers.py:
220-306) runs the reverse diffusion in bf16: the prior draw and every
score are cast to it, the noise is drawn in it, each step's tensors are
cast back to it (a predictor's update is f32 where an f32 SDE coefficient
meets it, as in JAX), the Langevin norms stay f32, and the outputs are
cast to f32.  JAX's ``lean`` scan only keeps its f32 means out of the
carry; this loop keeps the last step's means alone anyway.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Sequence

import torch

from ccsd_tpu_torch.diffusion.sde import SDE, _bcast, reverse_discretize, reverse_sde
from ccsd_tpu_torch.ops.cells import ComplexSpec
from ccsd_tpu_torch.ops.masks import gen_noise, gen_noise_rank2, mask_adjs, mask_rank2, mask_x


class SamplerOutput(NamedTuple):
    x: torch.Tensor
    adj: torch.Tensor
    n_model_evals: int
    rank2: Optional[torch.Tensor] = None


def _batch_norm_mean(v: torch.Tensor) -> torch.Tensor:
    """Mean over the batch of per-sample L2 norms, in f32."""
    v = v.to(torch.float32)
    return torch.linalg.vector_norm(v.reshape(v.shape[0], -1), dim=-1).mean()


def _langevin_step(sde: SDE, score, v, noise, t, snr, scale_eps,
                   grad_floor: Optional[float] = None):
    """One Langevin MCMC correction of tensor v given its score and noise.
    ``grad_floor`` bounds the score's norm below (the two-stage sampler's
    stage 2, whose batch may have no candidate cell at all: the step is
    then 0 rather than NaN)."""
    alpha = sde.alpha_of_t(t)
    grad_norm = _batch_norm_mean(score)
    if grad_floor is not None:
        grad_norm = grad_norm.clamp(min=grad_floor)
    noise_norm = _batch_norm_mean(noise)
    step_size = (snr * noise_norm / grad_norm) ** 2 * 2 * alpha
    v_mean = v + _bcast(step_size, v).to(v.dtype) * score
    v = v_mean + _bcast(torch.sqrt(step_size * 2), v).to(v.dtype) * noise * scale_eps
    return v, v_mean


def _noise_for(obj: str, v, flags, generator, spec=None):
    if obj == "rank2":
        return gen_noise_rank2(v, spec, flags, generator=generator)
    return gen_noise(v, flags, sym=(obj == "adj"), generator=generator)


def _make_corrector(corrector: str, obj: str, sde: SDE, snr, scale_eps,
                    n_steps: int, spec: Optional[ComplexSpec] = None):
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
            noise = _noise_for(obj, v, flags, generator, spec)
            v, v_mean = _langevin_step(sde, score, v, noise, t, snr, scale_eps)
        return v, v_mean

    return update


def _make_predictor(predictor: str, obj: str, sde: SDE, probability_flow: bool,
                    spec: Optional[ComplexSpec] = None):
    """(generator, score_eval, v, flags, t) -> (v, v_mean)."""
    if predictor == "Euler":
        rev = reverse_sde(sde, probability_flow)

        def update(generator, score_eval, v, flags, t):
            dt = -1.0 / sde.N
            z = _noise_for(obj, v, flags, generator, spec)
            drift, diffusion = rev(v, t, score_eval(v))
            v_mean = v + drift * dt
            return v_mean + _bcast(diffusion, v) * math.sqrt(-dt) * z, v_mean

        return update
    if predictor == "Reverse":
        rev = reverse_discretize(sde, probability_flow)

        def update(generator, score_eval, v, flags, t):
            f, G = rev(v, t, score_eval(v))
            z = _noise_for(obj, v, flags, generator, spec)
            v_mean = v - f
            return v_mean + _bcast(G, v) * z, v_mean

        return update
    raise NotImplementedError(
        f"Predictor {predictor} not supported. Select from [Reverse, Euler]."
    )


def _carry(carry_dtype: Optional[torch.dtype]):
    """(the cast of a carried tensor, the wrap of a score function, the cast
    of an output) for ``carry_dtype`` (None: f32, nothing cast)."""
    if carry_dtype is None:
        ident = lambda v: v  # noqa: E731
        return ident, ident, ident

    def wrap(fn):
        return lambda *a: fn(*a).to(carry_dtype)

    return (lambda v: v.to(carry_dtype)), wrap, (lambda v: v.to(torch.float32))


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
    is_cc: bool = False,
    sde_rank2: Optional[SDE] = None,
    shape_rank2: Optional[Sequence[int]] = None,
    spec: Optional[ComplexSpec] = None,
    carry_dtype: Optional[torch.dtype] = None,
) -> Callable:
    """Build ``sampler(score_fn_x, score_fn_adj, init_flags, generator)``,
    or with ``is_cc`` (and ``sde_rank2``, ``shape_rank2``, ``spec``)
    ``sampler(score_fn_x, score_fn_adj, score_fn_rank2, init_flags,
    generator)``; ``carry_dtype`` as above.

    Everything runs on the device of ``init_flags`` and of the generator.
    """
    shape_x, shape_adj = tuple(shape_x), tuple(shape_adj)
    diff_steps = sde_adj.N
    cast, wrap, out32 = _carry(carry_dtype)
    corr_x = _make_corrector(corrector, "x", sde_x, snr, scale_eps, n_steps)
    corr_adj = _make_corrector(corrector, "adj", sde_adj, snr, scale_eps, n_steps)
    pred_x = _make_predictor(predictor, "x", sde_x, probability_flow)
    pred_adj = _make_predictor(predictor, "adj", sde_adj, probability_flow)

    @torch.no_grad()
    def sampler(score_fn_x, score_fn_adj, init_flags: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> SamplerOutput:
        flags = init_flags
        dev = flags.device
        score_fn_x, score_fn_adj = wrap(score_fn_x), wrap(score_fn_adj)
        x = cast(mask_x(sde_x.prior_sampling(shape_x, generator, dev), flags))
        adj = cast(mask_adjs(sde_adj.prior_sampling_sym(shape_adj, generator, dev), flags))
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
            x, adj = cast(x), cast(adj)
        return SamplerOutput(
            x=out32(x_mean if denoise else x),
            adj=out32(adj_mean if denoise else adj),
            n_model_evals=diff_steps * (n_steps + 1),
        )

    if not is_cc:
        return sampler
    if sde_rank2 is None or shape_rank2 is None or spec is None:
        raise ValueError("CC sampling needs sde_rank2, shape_rank2 and spec")
    shape_rank2 = tuple(shape_rank2)
    corr_r2 = _make_corrector(corrector, "rank2", sde_rank2, snr, scale_eps, n_steps, spec)
    pred_r2 = _make_predictor(predictor, "rank2", sde_rank2, probability_flow, spec)

    @torch.no_grad()
    def sampler_cc(score_fn_x, score_fn_adj, score_fn_rank2, init_flags: torch.Tensor,
                   generator: Optional[torch.Generator] = None) -> SamplerOutput:
        flags = init_flags
        dev = flags.device
        score_fn_x, score_fn_adj, score_fn_rank2 = map(wrap, (score_fn_x, score_fn_adj,
                                                              score_fn_rank2))
        x = cast(mask_x(sde_x.prior_sampling(shape_x, generator, dev), flags))
        adj = cast(mask_adjs(sde_adj.prior_sampling_sym(shape_adj, generator, dev), flags))
        rank2 = cast(mask_rank2(sde_rank2.prior_sampling(shape_rank2, generator, dev), spec,
                                flags))
        timesteps = torch.linspace(sde_adj.T, eps, diff_steps, device=dev)
        x_mean, adj_mean, rank2_mean = x, adj, rank2
        for i in range(diff_steps):
            vec_t = timesteps[i].expand(shape_adj[0])

            _x, _adj = x, adj
            x, _ = corr_x(generator, lambda v: score_fn_x(v, adj, rank2, flags, vec_t),
                          x, flags, vec_t)
            adj, _ = corr_adj(generator, lambda v: score_fn_adj(_x, v, rank2, flags, vec_t),
                              adj, flags, vec_t)
            rank2, _ = corr_r2(generator,
                               lambda v: score_fn_rank2(_x, _adj, v, flags, vec_t),
                               rank2, flags, vec_t)

            _x, _adj = x, adj
            x, x_mean = pred_x(generator, lambda v: score_fn_x(v, adj, rank2, flags, vec_t),
                               x, flags, vec_t)
            adj, adj_mean = pred_adj(
                generator, lambda v: score_fn_adj(_x, v, rank2, flags, vec_t),
                adj, flags, vec_t)
            rank2, rank2_mean = pred_r2(
                generator, lambda v: score_fn_rank2(_x, _adj, v, flags, vec_t),
                rank2, flags, vec_t)
            x, adj, rank2 = cast(x), cast(adj), cast(rank2)
        return SamplerOutput(
            x=out32(x_mean if denoise else x),
            adj=out32(adj_mean if denoise else adj),
            n_model_evals=diff_steps * (n_steps + 1),
            rank2=out32(rank2_mean if denoise else rank2),
        )

    return sampler_cc


def get_s4_solver(
    sde_x: SDE,
    sde_adj: SDE,
    shape_x: Sequence[int],
    shape_adj: Sequence[int],
    snr: float = 0.1,
    scale_eps: float = 1.0,
    denoise: bool = True,
    eps: float = 1e-3,
    is_cc: bool = False,
    sde_rank2: Optional[SDE] = None,
    shape_rank2: Optional[Sequence[int]] = None,
    spec: Optional[ComplexSpec] = None,
    carry_dtype: Optional[torch.dtype] = None,
) -> Callable:
    """The S4 splitting solver (ccsd_tpu/diffusion/solvers.py:366-500): each
    step evaluates every network once on the step's state, corrects each
    tensor by one Langevin step on that score, then moves it by the SDE's
    transition kernel over half a step, the score drift over a whole one
    and the kernel over the second half.  Returns ``solver(score_fn_x,
    score_fn_adj, init_flags, generator)``, or with ``is_cc``
    ``solver(score_fn_x, score_fn_adj, score_fn_rank2, init_flags,
    generator)``; with ``denoise`` the last step's transition means.  The
    SDEs must have a transition kernel (VP, VE).  ``carry_dtype`` is taken
    and ignored, as the JAX solver takes ``sample.dtype`` and ignores it
    (``**_unused``, :378): S4 runs in f32."""
    del carry_dtype
    shape_x, shape_adj = tuple(shape_x), tuple(shape_adj)
    diff_steps = sde_adj.N
    dt = -1.0 / diff_steps
    if is_cc and (sde_rank2 is None or shape_rank2 is None or spec is None):
        raise ValueError("CC sampling needs sde_rank2, shape_rank2 and spec")
    shape_rank2 = tuple(shape_rank2) if is_cc else None

    def drift(sde, v, score, vec_t):
        return -_bcast(sde.sde(v, vec_t)[1], v) ** 2 * score

    def correct(generator, sde, score, v, obj, flags, vec_t):
        noise = _noise_for(obj, v, flags, generator, spec)
        return _langevin_step(sde, score, v, noise, vec_t, snr, scale_eps)[0]

    def predict(generator, sde, v, s_drift, obj, flags, vec_t, vec_dt):
        mu, sigma = sde.transition(v, vec_t, vec_dt)
        v = mu + _bcast(sigma, v) * _noise_for(obj, v, flags, generator, spec)
        v = v + s_drift * dt
        mu, sigma = sde.transition(v, vec_t + vec_dt, vec_dt)
        return mu + _bcast(sigma, v) * _noise_for(obj, v, flags, generator, spec), mu

    @torch.no_grad()
    def run(score_fns, sdes, objs, init_flags, generator):
        flags = init_flags
        dev = flags.device
        state = [mask_x(sde_x.prior_sampling(shape_x, generator, dev), flags),
                 mask_adjs(sde_adj.prior_sampling_sym(shape_adj, generator, dev), flags)]
        if is_cc:
            state.append(mask_rank2(sde_rank2.prior_sampling(shape_rank2, generator, dev),
                                    spec, flags))
        means = list(state)
        timesteps = torch.linspace(sde_adj.T, eps, diff_steps, device=dev)
        vec_dt = torch.full((shape_adj[0],), dt / 2, device=dev)
        for i in range(diff_steps):
            vec_t = timesteps[i].expand(shape_adj[0])
            scores = [fn(*state, flags, vec_t) for fn in score_fns]
            drifts = [drift(sde, v, s, vec_t) for sde, v, s in zip(sdes, state, scores)]
            state = [correct(generator, sde, s, v, obj, flags, vec_t)
                     for sde, s, v, obj in zip(sdes, scores, state, objs)]
            moved = [predict(generator, sde, v, d, obj, flags, vec_t, vec_dt)
                     for sde, v, d, obj in zip(sdes, state, drifts, objs)]
            state, means = [m[0] for m in moved], [m[1] for m in moved]
        out = means if denoise else state
        return SamplerOutput(x=out[0], adj=out[1], n_model_evals=diff_steps,
                             rank2=out[2] if is_cc else None)

    if not is_cc:
        def solver(score_fn_x, score_fn_adj, init_flags: torch.Tensor,
                   generator: Optional[torch.Generator] = None) -> SamplerOutput:
            return run((score_fn_x, score_fn_adj), (sde_x, sde_adj), ("x", "adj"),
                       init_flags, generator)

        return solver

    def solver_cc(score_fn_x, score_fn_adj, score_fn_rank2, init_flags: torch.Tensor,
                  generator: Optional[torch.Generator] = None) -> SamplerOutput:
        return run((score_fn_x, score_fn_adj, score_fn_rank2), (sde_x, sde_adj, sde_rank2),
                   ("x", "adj", "rank2"), init_flags, generator)

    return solver_cc
