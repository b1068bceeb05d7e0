"""Stochastic differential equations (VP / VE / subVP) on torch tensors.

Port of ccsd_tpu/diffusion/sde.py:27-305, with the S4 solver's
transition kernels of VPSDE and VESDE (:136, :191; subVPSDE has none and
raises, as the JAX base class does).  The discrete tables
(``discrete_betas``, ``discrete_sigmas``) are evaluated in closed form from
the timestep index, as in the JAX package, so the sampler never gathers
from a host table.  ``timestep_of`` truncates toward zero, as the reference
does.  Prior sampling draws from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch


def _bcast(scalar: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Broadcast a (B,) per-sample scalar against (B, ...) tensors."""
    return scalar.reshape(tuple(scalar.shape) + (1,) * (like.dim() - scalar.dim()))


@dataclass(frozen=True)
class SDE:
    """Base: N discretisation steps, final time T = 1."""

    N: int = 1000

    @property
    def T(self) -> float:
        return 1.0

    def sde(self, x, t) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def marginal_std(self, t: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def transition(self, x, t, dt) -> Tuple[torch.Tensor, torch.Tensor]:
        """Mean and std of the transition kernel from t over dt (the S4
        solver's)."""
        raise NotImplementedError(f"{type(self).__name__} has no transition kernel")

    def discretize(self, x, t) -> Tuple[torch.Tensor, torch.Tensor]:
        """Euler discretisation x_{i+1} = x_i + f_i + G_i z."""
        dt = 1.0 / self.N
        drift, diffusion = self.sde(x, t)
        return drift * dt, diffusion * math.sqrt(dt)

    def timestep_of(self, t: torch.Tensor) -> torch.Tensor:
        """Continuous time -> integer table index (truncation toward zero)."""
        return (t * (self.N - 1) / self.T).to(torch.int32)

    def prior_sampling(self, shape: Sequence[int],
                       generator: Optional[torch.Generator] = None,
                       device=None) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=generator, device=device)

    def prior_sampling_sym(self, shape: Sequence[int],
                           generator: Optional[torch.Generator] = None,
                           device=None) -> torch.Tensor:
        x = torch.triu(torch.randn(tuple(shape), generator=generator,
                                   device=device), diagonal=1)
        return x + x.transpose(-1, -2)


def _discrete_beta(sde, i: torch.Tensor) -> torch.Tensor:
    lo, hi = sde.beta_min / sde.N, sde.beta_max / sde.N
    step = (hi - lo) / (sde.N - 1) if sde.N > 1 else 0.0
    return lo + i.to(torch.float32) * step


def _log_mean_coeff(sde, t):
    return -0.25 * t**2 * (sde.beta_max - sde.beta_min) - 0.5 * t * sde.beta_min


@dataclass(frozen=True)
class VPSDE(SDE):
    """Variance-preserving SDE."""

    beta_min: float = 0.1
    beta_max: float = 20.0

    def beta_t(self, t):
        return self.beta_min + t * (self.beta_max - self.beta_min)

    def sde(self, x, t):
        beta_t = self.beta_t(t)
        return -0.5 * _bcast(beta_t, x) * x, torch.sqrt(beta_t)

    def marginal_prob(self, x, t):
        lmc = _log_mean_coeff(self, t)
        return torch.exp(_bcast(lmc, x)) * x, torch.sqrt(1.0 - torch.exp(2.0 * lmc))

    def marginal_std(self, t):
        return torch.sqrt(1.0 - torch.exp(2.0 * _log_mean_coeff(self, t)))

    def discrete_beta(self, i: torch.Tensor) -> torch.Tensor:
        return _discrete_beta(self, i)

    def alpha_of_t(self, t: torch.Tensor) -> torch.Tensor:
        """alphas[timestep(t)], used by the Langevin corrector."""
        return 1.0 - self.discrete_beta(self.timestep_of(t))

    def discretize(self, x, t):
        """DDPM discretisation."""
        beta = self.discrete_beta(self.timestep_of(t))
        f = _bcast(torch.sqrt(1.0 - beta), x) * x - x
        return f, torch.sqrt(beta)

    def transition(self, x, t, dt):
        lmc = 0.25 * dt * (2 * self.beta_min + (2 * t + dt) * (self.beta_max - self.beta_min))
        return torch.exp(_bcast(-lmc, x)) * x, torch.sqrt(1.0 - torch.exp(2.0 * lmc))


@dataclass(frozen=True)
class VESDE(SDE):
    """Variance-exploding SDE."""

    sigma_min: float = 0.01
    sigma_max: float = 50.0

    def sigma_t(self, t):
        return self.sigma_min * (self.sigma_max / self.sigma_min) ** t

    def sde(self, x, t):
        diffusion = self.sigma_t(t) * math.sqrt(
            2 * (math.log(self.sigma_max) - math.log(self.sigma_min))
        )
        return torch.zeros_like(x), diffusion

    def marginal_prob(self, x, t):
        return x, self.sigma_t(t)

    def marginal_std(self, t):
        return self.sigma_t(t)

    def alpha_of_t(self, t):
        return torch.ones_like(t)

    def discrete_sigma(self, i: torch.Tensor) -> torch.Tensor:
        lo, hi = math.log(self.sigma_min), math.log(self.sigma_max)
        step = (hi - lo) / (self.N - 1) if self.N > 1 else 0.0
        return torch.exp(lo + i.to(torch.float32) * step)

    def discretize(self, x, t):
        """SMLD (NCSN) discretisation."""
        i = self.timestep_of(t)
        sigma = self.discrete_sigma(i)
        adjacent = torch.where(i == 0, torch.zeros_like(t), self.discrete_sigma(i - 1))
        return torch.zeros_like(x), torch.sqrt(sigma**2 - adjacent**2)

    def transition(self, x, t, dt):
        var = torch.square(self.sigma_t(t)) - torch.square(self.sigma_t(t + dt))
        return x, torch.sqrt(var)


@dataclass(frozen=True)
class subVPSDE(SDE):
    """sub-VP SDE."""

    beta_min: float = 0.1
    beta_max: float = 20.0

    def beta_t(self, t):
        return self.beta_min + t * (self.beta_max - self.beta_min)

    def sde(self, x, t):
        beta_t = self.beta_t(t)
        discount = 1.0 - torch.exp(
            -2 * self.beta_min * t - (self.beta_max - self.beta_min) * t**2
        )
        return -0.5 * _bcast(beta_t, x) * x, torch.sqrt(beta_t * discount)

    def marginal_prob(self, x, t):
        lmc = _log_mean_coeff(self, t)
        return torch.exp(_bcast(lmc, x)) * x, 1.0 - torch.exp(2.0 * lmc)

    def marginal_std(self, t):
        return 1.0 - torch.exp(2.0 * _log_mean_coeff(self, t))

    def discrete_beta(self, i: torch.Tensor) -> torch.Tensor:
        return _discrete_beta(self, i)

    def alpha_of_t(self, t: torch.Tensor) -> torch.Tensor:
        return 1.0 - self.discrete_beta(self.timestep_of(t))


def is_vp_like(sde: SDE) -> bool:
    """VP/subVP use -score/std scaling and discrete-alpha Langevin steps."""
    return isinstance(sde, (VPSDE, subVPSDE))


def reverse_sde(sde: SDE, probability_flow: bool = False):
    """Reverse-time (drift, diffusion) given the score at (x, t)."""

    def rev(x, t, score):
        drift, diffusion = sde.sde(x, t)
        drift = drift - _bcast(diffusion, x) ** 2 * score * (
            0.5 if probability_flow else 1.0)
        return drift, torch.zeros_like(diffusion) if probability_flow else diffusion

    return rev


def reverse_discretize(sde: SDE, probability_flow: bool = False):
    """Discretised reverse iteration (f, G)."""

    def rev(x, t, score):
        f, G = sde.discretize(x, t)
        rev_f = f - _bcast(G, x) ** 2 * score * (0.5 if probability_flow else 1.0)
        return rev_f, torch.zeros_like(G) if probability_flow else G

    return rev


def load_sde(config_sde) -> SDE:
    """Build an SDE from a config node {type, beta_min, beta_max, num_scales}."""
    t = config_sde.type
    if t == "VP":
        return VPSDE(N=config_sde.num_scales, beta_min=config_sde.beta_min,
                     beta_max=config_sde.beta_max)
    if t == "VE":
        return VESDE(N=config_sde.num_scales, sigma_min=config_sde.beta_min,
                     sigma_max=config_sde.beta_max)
    if t == "subVP":
        return subVPSDE(N=config_sde.num_scales, beta_min=config_sde.beta_min,
                        beta_max=config_sde.beta_max)
    raise NotImplementedError(f"SDE class {t} not supported.")
