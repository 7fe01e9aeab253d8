"""Straggler model of ADEL-FL (Model Formulations B1-B3, Appendix A), in
PyTorch (port of ``repro.core.straggler``).

Per-layer backprop time of user u is Exp(S_t^u / P_u) (mean S/P), so the
number of layer-gradients completed within the effective deadline
T_t^d - B_u is z_t^u ~ Poisson(lambda_t^u) with

    lambda_t^u = P_u / S_t^u * (T_t^d - B_u).

Backprop runs from the output layer L toward the input layer 1: user u
contributes layer l iff z_t^u >= L + 1 - l.

Random draws come from an explicit ``torch.Generator`` (or a draw source
with the same methods, see :class:`repro_torch.fl.runtime.Draws`); these
(U,)-sized computations run on the host, on the CPU tensors the policies
build from the config's numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from .gamma import log_q_gamma_all
from .types import AnalysisConfig

__all__ = ["batch_sizes", "poisson_rates", "sample_depths",
           "contribution_mask", "exact_p_layers", "late_p_layers",
           "late_arrival_delays", "sample_round", "fixed_batch",
           "sample_round_fixed", "simulate_p_empirical"]


def _f32(a) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32)


def batch_sizes(T_d, m, P, B) -> torch.Tensor:
    """Model Formulation B3: S^u = floor(m P_u (T^d - B_u)/T^d), clipped >= 1."""
    T_d, P, B = _f32(T_d), _f32(P), _f32(B)
    S = torch.floor(m * P * torch.clamp(T_d - B, min=0.0)
                    / torch.clamp(T_d, min=1e-9))
    return torch.clamp(S, min=1.0)


def poisson_rates(T_d, m, P, B) -> torch.Tensor:
    """lambda^u = P_u / S^u * (T^d - B_u), with S^u from B3 (Eq. A.2)."""
    S = batch_sizes(T_d, m, P, B)
    return _f32(P) / S * torch.clamp(_f32(T_d) - _f32(B), min=0.0)


def sample_depths(gen: torch.Generator, lam: torch.Tensor) -> torch.Tensor:
    """z^u ~ Poisson(lambda^u): number of layers completed (unbounded)."""
    return torch.poisson(lam, generator=gen)


def contribution_mask(z: torch.Tensor, L: int) -> torch.Tensor:
    """mask[u, l-1] = 1 iff user u contributes layer l, i.e. z_u >= L + 1 - l."""
    thresh = L - torch.arange(L, device=z.device)        # L, L-1, ..., 1
    return (z[:, None] >= thresh[None, :]).to(torch.float32)


def exact_p_layers(lam: torch.Tensor, L: int) -> torch.Tensor:
    """Exact p_t^l = prod_u Q(L+1-l, lambda_u); shape (L,), entry l-1.

    Tighter than the Lemma-1 bound; the server's Eq. (5) bias correction.
    """
    logq = log_q_gamma_all(L, lam)                       # (U, L)
    return torch.exp(torch.flip(logq.sum(0), dims=(-1,)))


def late_p_layers(lam: torch.Tensor, L: int) -> torch.Tensor:
    """Probability that NO user is late at layer l:
    prod_u (1 - Q(L+1-l, lambda_u)); shape (L,)."""
    q = torch.flip(torch.exp(log_q_gamma_all(L, lam)), dims=(-1,))
    return torch.prod(1.0 - q, dim=0)


def late_arrival_delays(depth, layer_s, B, L: int) -> torch.Tensor:
    """Expected extra simulated time for each straggler to finish its
    remaining ``L - z_u`` layer-gradients (mean ``S_u/P_u`` each) and upload
    again (``B_u``)."""
    rem = torch.clamp(float(L) - _f32(depth), min=0.0)
    return rem * _f32(layer_s) + _f32(B)


def sample_round(draw, T_d, m, cfg: AnalysisConfig):
    """One round's straggler draw under B3 batch scaling (ADEL-FL):
    (mask (U,L), p (L,), S (U,), z (U,)). ``draw(lam)`` returns the
    Poisson depths."""
    P, B = _f32(cfg.P), _f32(cfg.B_eff)
    lam = poisson_rates(T_d, m, P, B)
    z = draw(lam)
    mask = contribution_mask(z, cfg.L)
    p = exact_p_layers(lam, cfg.L)
    return mask, p, batch_sizes(T_d, m, P, B), z


def fixed_batch(T_d, m, cfg: AnalysisConfig) -> float:
    """The FIXED per-user batch size of the baselines (SALF / Drop / Wait
    fix one batch size for everyone; B3's per-user scaling is ADEL-FL's)."""
    P_mean = float(np.mean(cfg.P))
    B_mean = float(np.mean(cfg.B_eff))
    S = np.floor(m * P_mean * max(T_d - B_mean, 0.0) / max(T_d, 1e-9))
    return float(np.float32(max(S, 1.0)))


def sample_round_fixed(draw, T_d, S, cfg: AnalysisConfig):
    """Straggler draw with a uniform batch size S for every user.
    Returns (mask, p, lam)."""
    P, B = _f32(cfg.P), _f32(cfg.B_eff)
    lam = P / S * torch.clamp(_f32(T_d) - B, min=0.0)
    z = draw(lam)
    mask = contribution_mask(z, cfg.L)
    p = exact_p_layers(lam, cfg.L)
    return mask, p, lam


def simulate_p_empirical(T_d: float, m: float, cfg: AnalysisConfig,
                         n_trials: int = 2000, seed: int = 0) -> np.ndarray:
    """Monte-Carlo estimate of p_t^l (validates Lemma 1)."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    lam = poisson_rates(T_d, m, cfg.P, cfg.B_eff)
    z = torch.poisson(lam.expand(n_trials, -1).contiguous(), generator=gen)
    thresh = cfg.L - torch.arange(cfg.L)
    masks = (z[:, :, None] >= thresh[None, None, :]).to(torch.float32)
    none = (masks.sum(1) == 0).to(torch.float32)          # (n, L)
    return none.mean(0).numpy()
