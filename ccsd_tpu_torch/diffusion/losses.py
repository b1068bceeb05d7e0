"""Score wrapper and the denoising score-matching (DSM) loss of the graph
score networks.

Port of ``get_score_fn`` and ``get_score_fn_cc`` (ccsd_tpu/diffusion/
losses.py:49-100): VP and subVP scale the network output by -1/std(t); VE
returns it as it is.  And of ``get_sde_loss_fn`` (:102-163) and
``get_sde_loss_fn_cc`` (:166-240), each split in two: ``draw`` draws t and
the masked noise from an explicit ``torch.Generator`` (t, then z_x, then
z_adj, then in CC mode z_rank2, the JAX key order), and ``losses`` takes
the draws as arguments, so a test can feed it the JAX package's.  The
networks are arguments of the call, as the JAX loss takes their
parameters, so one loss serves the trained networks and their EMA copies.
The CC networks are called with keywords (``rank2=``, ``flags=``):
ScoreNetworkX takes the rank-2 tensor and ignores it.  The two-stage
model's stage 2 has its score function over a per-sample candidate-cell
universe (``get_score_fn_rank2_dynamic``, :242-268) and its DSM loss of F
alone (``Rank2DynamicLoss``, :271-310), which draws t, then the masked
noise, from its own generator.

``compute_dtype`` (``sample.score_dtype: bf16``, the JAX package's
selective precision, losses.py:29-46) runs the network on a copy of its
parameters in that dtype, made once (``models/nn.py cast_copy``; the
caller's module is unchanged), with every input and the flags cast to it,
and returns f32 scores; the -1/std scale follows the output's dtype, as
the JAX code divides (f32 after that cast; the network's own dtype under
the bf16 carry, where no cast is asked).  ``carry_dtype`` (``sample.dtype:
bf16``, the bf16 carry) gives ``get_score_fn_cc`` the JAX CC networks'
following of the rank-2 tensor's dtype: a network that follows it
(``follows_rank2_dtype``: both CC adjacency networks and ScoreNetworkF's
slab form) runs on a copy of its parameters in the carry's dtype, made
once; the others promote the carry to their f32 parameters, as in JAX.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ccsd_tpu_torch.diffusion.sde import SDE, VESDE, _bcast, is_vp_like
from ccsd_tpu_torch.models.nn import cast_copy, param_dtype
from ccsd_tpu_torch.ops.cells import ComplexSpec
from ccsd_tpu_torch.ops.masks import (
    gen_noise,
    gen_noise_rank2,
    gen_noise_rank2_dynamic,
    mask_adjs,
    mask_rank2,
    mask_rank2_dynamic,
    mask_x,
    node_flags,
)


def _compute_cast(model, compute_dtype: Optional[torch.dtype]):
    """(the module to call, the cast of its inputs, the cast of its output)
    for ``compute_dtype`` (None: the module as it is)."""
    if compute_dtype is None:
        return model, (lambda v: v), (lambda v: v)
    if param_dtype(model) != compute_dtype:
        model = cast_copy(model, compute_dtype)
    return (model,
            lambda v: None if v is None else v.to(compute_dtype),
            lambda v: v.to(torch.float32))


def get_score_fn(sde: SDE, model, compute_dtype: Optional[torch.dtype] = None) -> Callable:
    """Graph score function (x, adj, flags, t) -> score."""
    model, cin, cout = _compute_cast(model, compute_dtype)
    if is_vp_like(sde):

        def score_fn(x, adj, flags, t):
            out = cout(model(cin(x), cin(adj), cin(flags)))
            return -out / _bcast(sde.marginal_std(t), out).to(out.dtype)

    elif isinstance(sde, VESDE):

        def score_fn(x, adj, flags, t):
            return cout(model(cin(x), cin(adj), cin(flags)))

    else:
        raise NotImplementedError(f"SDE class {type(sde).__name__} not supported.")
    return score_fn


def get_score_fn_cc(sde: SDE, model, compute_dtype: Optional[torch.dtype] = None,
                    carry_dtype: Optional[torch.dtype] = None) -> Callable:
    """CC score function (x, adj, rank2, flags, t) -> score."""
    if carry_dtype is not None and getattr(model, "follows_rank2_dtype", False):
        model = cast_copy(model, carry_dtype)
    model, cin, cout = _compute_cast(model, compute_dtype)
    if is_vp_like(sde):

        def score_fn(x, adj, rank2, flags, t):
            out = cout(model(cin(x), cin(adj), rank2=cin(rank2), flags=cin(flags)))
            return -out / _bcast(sde.marginal_std(t), out).to(out.dtype)

    elif isinstance(sde, VESDE):

        def score_fn(x, adj, rank2, flags, t):
            return cout(model(cin(x), cin(adj), rank2=cin(rank2), flags=cin(flags)))

    else:
        raise NotImplementedError(f"SDE class {type(sde).__name__} not supported.")
    return score_fn


def get_score_fn_rank2_dynamic(sde: SDE, model, dyn) -> Callable:
    """Stage-2 score function (rank2, flags, t) -> score of ScoreNetworkF
    over the per-sample universe ``dyn`` (``diffusion.two_stage.
    DynamicCells``: member (B, K, N), valid (B, K))."""
    dyn = (dyn.member, dyn.valid)
    if is_vp_like(sde):

        def score_fn(rank2, flags, t):
            out = model(None, None, rank2, flags=flags, dyn=dyn)
            return -out / _bcast(sde.marginal_std(t), out)

    elif isinstance(sde, VESDE):

        def score_fn(rank2, flags, t):
            return model(None, None, rank2, flags=flags, dyn=dyn)

    else:
        raise NotImplementedError(f"SDE class {type(sde).__name__} not supported.")
    return score_fn


def _reduce(losses: torch.Tensor, reduce_mean: bool) -> torch.Tensor:
    flat = losses.reshape(losses.shape[0], -1)
    return flat.mean(dim=-1) if reduce_mean else 0.5 * flat.sum(dim=-1)


class SDELoss:
    """DSM loss for (X, A): ``loss(model_x, model_adj, x, adj, generator)
    -> (loss_x, loss_adj)``, each the batch mean."""

    def __init__(self, sde_x: SDE, sde_adj: SDE, reduce_mean: bool = False,
                 likelihood_weighting: bool = False, eps: float = 1e-5):
        self.sde_x, self.sde_adj = sde_x, sde_adj
        self.reduce_mean = reduce_mean
        self.likelihood_weighting = likelihood_weighting
        self.eps = eps

    def draw(self, x: torch.Tensor, adj: torch.Tensor,
             generator: Optional[torch.Generator] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(t (B,), z_x, z_adj): t uniform in [eps, T), Gaussian noise masked
        by the adjacency's node flags, symmetric with a zero diagonal for
        the adjacency."""
        flags = node_flags(adj)
        u = torch.rand((adj.shape[0],), generator=generator, dtype=adj.dtype,
                       device=adj.device)
        t = u * (self.sde_adj.T - self.eps) + self.eps
        z_x = gen_noise(x, flags, sym=False, generator=generator)
        z_adj = gen_noise(adj, flags, sym=True, generator=generator)
        return t, z_x, z_adj

    def _dsm(self, sde: SDE, score: torch.Tensor, std: torch.Tensor, z: torch.Tensor,
             v: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """Per-sample DSM loss of one object (ccsd_tpu/diffusion/losses.py:
        146-161): |score std + z|², or |score + z / std|² g(t)² with
        likelihood weighting."""
        if not self.likelihood_weighting:
            return _reduce(torch.square(score * _bcast(std, score) + z), self.reduce_mean)
        g2 = sde.sde(torch.zeros_like(v), t)[1] ** 2
        return _reduce(torch.square(score + z / _bcast(std, z)), self.reduce_mean) * g2

    def losses(self, model_x, model_adj, x: torch.Tensor, adj: torch.Tensor,
               t: torch.Tensor, z_x: torch.Tensor, z_adj: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The losses at given draws (ccsd_tpu/diffusion/losses.py:133-161)."""
        sde_x, sde_adj = self.sde_x, self.sde_adj
        flags = node_flags(adj)
        mean_x, std_x = sde_x.marginal_prob(x, t)
        perturbed_x = mask_x(mean_x + _bcast(std_x, x) * z_x, flags)
        mean_adj, std_adj = sde_adj.marginal_prob(adj, t)
        perturbed_adj = mask_adjs(mean_adj + _bcast(std_adj, adj) * z_adj, flags)

        score_x = get_score_fn(sde_x, model_x)(perturbed_x, perturbed_adj, flags, t)
        score_adj = get_score_fn(sde_adj, model_adj)(perturbed_x, perturbed_adj, flags, t)

        lx = self._dsm(sde_x, score_x, std_x, z_x, x, t)
        la = self._dsm(sde_adj, score_adj, std_adj, z_adj, adj, t)
        return lx.mean(), la.mean()

    def __call__(self, model_x, model_adj, x: torch.Tensor, adj: torch.Tensor,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.losses(model_x, model_adj, x, adj, *self.draw(x, adj, generator))


class SDELossCC(SDELoss):
    """DSM loss for (X, A, F): ``loss(model_x, model_adj, model_rank2, x,
    adj, rank2, generator) -> (loss_x, loss_adj, loss_rank2)``, each the
    batch mean.  The rank-2 noise is masked by ``mask_rank2`` and not
    symmetrised; the perturbed rank-2 tensor is masked the same way."""

    def __init__(self, sde_x: SDE, sde_adj: SDE, sde_rank2: SDE, spec: ComplexSpec,
                 reduce_mean: bool = False, likelihood_weighting: bool = False,
                 eps: float = 1e-5):
        super().__init__(sde_x, sde_adj, reduce_mean, likelihood_weighting, eps)
        self.sde_rank2, self.spec = sde_rank2, spec

    def draw(self, x: torch.Tensor, adj: torch.Tensor, rank2: torch.Tensor,
             generator: Optional[torch.Generator] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """(t, z_x, z_adj, z_rank2), drawn in that order."""
        t, z_x, z_adj = super().draw(x, adj, generator)
        z_rank2 = gen_noise_rank2(rank2, self.spec, node_flags(adj), generator=generator)
        return t, z_x, z_adj, z_rank2

    def losses(self, model_x, model_adj, model_rank2, x: torch.Tensor, adj: torch.Tensor,
               rank2: torch.Tensor, t: torch.Tensor, z_x: torch.Tensor,
               z_adj: torch.Tensor, z_rank2: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The losses at given draws (ccsd_tpu/diffusion/losses.py:182-238)."""
        sde_x, sde_adj, sde_r2 = self.sde_x, self.sde_adj, self.sde_rank2
        flags = node_flags(adj)
        mean_x, std_x = sde_x.marginal_prob(x, t)
        px = mask_x(mean_x + _bcast(std_x, x) * z_x, flags)
        mean_adj, std_adj = sde_adj.marginal_prob(adj, t)
        padj = mask_adjs(mean_adj + _bcast(std_adj, adj) * z_adj, flags)
        mean_r2, std_r2 = sde_r2.marginal_prob(rank2, t)
        pr2 = mask_rank2(mean_r2 + _bcast(std_r2, rank2) * z_rank2, self.spec, flags)

        scores = [get_score_fn_cc(sde, m)(px, padj, pr2, flags, t)
                  for sde, m in ((sde_x, model_x), (sde_adj, model_adj),
                                 (sde_r2, model_rank2))]
        lx = self._dsm(sde_x, scores[0], std_x, z_x, x, t)
        la = self._dsm(sde_adj, scores[1], std_adj, z_adj, adj, t)
        lr = self._dsm(sde_r2, scores[2], std_r2, z_rank2, rank2, t)
        return lx.mean(), la.mean(), lr.mean()

    def __call__(self, model_x, model_adj, model_rank2, x: torch.Tensor,
                 adj: torch.Tensor, rank2: torch.Tensor,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return self.losses(model_x, model_adj, model_rank2, x, adj, rank2,
                           *self.draw(x, adj, rank2, generator))


def get_sde_loss_fn(sde_x: SDE, sde_adj: SDE, reduce_mean: bool = False,
                    likelihood_weighting: bool = False, eps: float = 1e-5) -> SDELoss:
    """DSM loss for (X, A) (ccsd_tpu/diffusion/losses.py:109-163)."""
    return SDELoss(sde_x, sde_adj, reduce_mean, likelihood_weighting, eps)


class Rank2DynamicLoss:
    """DSM loss of F alone over per-sample candidate universes, the
    two-stage model's stage 2: ``loss(model_rank2, rank2, flags, member,
    valid, generator) -> loss``, the batch mean."""

    def __init__(self, sde_rank2: SDE, spec: ComplexSpec, reduce_mean: bool = False,
                 eps: float = 1e-5):
        self.sde, self.spec = sde_rank2, spec
        self.reduce_mean, self.eps = reduce_mean, eps

    def draw(self, rank2: torch.Tensor, flags: torch.Tensor, member: torch.Tensor,
             valid: torch.Tensor, generator: Optional[torch.Generator] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(t (B,), z): t uniform in [eps, T), then Gaussian noise masked by
        ``mask_rank2_dynamic``."""
        u = torch.rand((rank2.shape[0],), generator=generator, dtype=rank2.dtype,
                       device=rank2.device)
        t = u * (self.sde.T - self.eps) + self.eps
        z = gen_noise_rank2_dynamic(rank2, self.spec, member, valid, flags, generator)
        return t, z

    def losses(self, model, rank2: torch.Tensor, flags: torch.Tensor, member: torch.Tensor,
               valid: torch.Tensor, t: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """The loss at given draws (ccsd_tpu/diffusion/losses.py:287-308)."""
        mean, std = self.sde.marginal_prob(rank2, t)
        perturbed = mask_rank2_dynamic(mean + _bcast(std, rank2) * z, self.spec, member,
                                       valid, flags)
        out = model(None, None, perturbed, flags=flags, dyn=(member, valid))
        score = -out / _bcast(std, out) if is_vp_like(self.sde) else out
        return _reduce(torch.square(score * _bcast(std, score) + z), self.reduce_mean).mean()

    def __call__(self, model, rank2: torch.Tensor, flags: torch.Tensor, member: torch.Tensor,
                 valid: torch.Tensor, generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        return self.losses(model, rank2, flags, member, valid,
                           *self.draw(rank2, flags, member, valid, generator))


def get_rank2_dynamic_loss_fn(sde_rank2: SDE, spec: ComplexSpec, reduce_mean: bool = False,
                              eps: float = 1e-5) -> Rank2DynamicLoss:
    """DSM loss of F over per-sample universes (ccsd_tpu/diffusion/losses.py:
    271-310)."""
    return Rank2DynamicLoss(sde_rank2, spec, reduce_mean, eps)
