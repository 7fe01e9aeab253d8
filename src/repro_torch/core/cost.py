"""Theorem-1 convergence bound: the Problem-2 objective of ADEL-FL
(port of ``repro.core.cost``).

    E||w_{R+1} - w_opt||^2 <= prod_t (1 - eta_t rho_c) * Delta_1
        + sum_t eta_t^2 (B_t + C_t) * prod_{tau>t} (1 - eta_tau rho_c)

with (Eq. 11)

    B_t = (1/U^2) sum_u sigma_u^2 / (m P_u (T_t - B_u)/T_t - 1) + 6 rho_s Gamma
    C_t = G^2 4U/(U-1) sum_l (1 + Q(L+1-l, T_t/m)^U) / (1 - 5 Q(L+1-l, T_t/m)^U)

Every function is plain float32 PyTorch on the device of ``T``, and
differentiable in (T, m) through autograd, so the scheduler can drive it
with its hand-written Adam or hand scipy exact gradients.
"""
from __future__ import annotations

import torch

from .gamma import log_q_gamma_all
from .types import AnalysisConfig

__all__ = ["b_term", "c_term", "p1_round", "theorem1_bound",
           "objective_and_penalty", "upload_bytes"]

_EPS = 1e-6


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device=device)


def _u_vec(cfg: AnalysisConfig, device) -> torch.Tensor:
    """Per-round contributor count, shape (R,): ``U_round`` when the config
    carries an availability forecast, else the static ``U``."""
    if cfg.U_round is None:
        return torch.full((cfg.R,), float(cfg.U), dtype=torch.float32,
                          device=device)
    return _f32(cfg.U_round, device)


def b_term(T: torch.Tensor, m: torch.Tensor, cfg: AnalysisConfig) -> torch.Tensor:
    """Stochastic-gradient variance term B_t. T: (R,) -> (R,)."""
    dev = T.device
    m = _f32(m, dev)
    P = _f32(cfg.P, dev)
    B = _f32(cfg.B_eff, dev)          # wire-compressed comm time
    s2 = _f32(cfg.sigma2, dev)
    frac = (T[:, None] - B[None, :]) / torch.clamp(T[:, None], min=_EPS)
    denom = torch.clamp(m * P[None, :] * frac - 1.0, min=_EPS)
    u = _u_vec(cfg, dev)
    return (s2[None, :] / denom).sum(-1) / (u * cfg.U) \
        + 6.0 * cfg.rho_s * cfg.het_gap


def _log_qU(T: torch.Tensor, m: torch.Tensor, cfg: AnalysisConfig) -> torch.Tensor:
    """U_t * log Q(L+1-l, T_t/m) for l = 1..L; shape (R, L)."""
    x = T / torch.clamp(_f32(m, T.device), min=_EPS)
    logq = torch.flip(log_q_gamma_all(cfg.L, x), dims=(-1,))
    return _u_vec(cfg, T.device)[:, None] * logq


def c_term(T: torch.Tensor, m: torch.Tensor, cfg: AnalysisConfig) -> torch.Tensor:
    """Deadline-truncation variance term C_t. T: (R,) -> (R,)."""
    qU = torch.exp(_log_qU(T, m, cfg))
    denom = torch.clamp(1.0 - 5.0 * qU, min=_EPS)   # valid iff p_t^1 < 0.2
    ratio = (1.0 + qU) / denom
    u = _u_vec(cfg, T.device)
    return cfg.G2 * (4.0 * u / (u - 1.0)) * ratio.sum(-1)


def p1_round(T: torch.Tensor, m: torch.Tensor, cfg: AnalysisConfig) -> torch.Tensor:
    """p_t^1 bound = Q(L, T_t/m)^U per round (the binding Lemma-1 constraint)."""
    return torch.exp(_log_qU(T, m, cfg)[:, 0])


def theorem1_bound(T: torch.Tensor, m: torch.Tensor, cfg: AnalysisConfig) -> torch.Tensor:
    """The full right-hand side of Theorem 1 (Eq. 10)."""
    eta = _f32(cfg.eta, T.device)
    decay = 1.0 - eta * cfg.rho_c
    # prod_{tau=t+1}^{R} decay_tau for t = 1..R (exclusive reversed cumprod)
    rev = torch.cumprod(torch.flip(decay, dims=(0,)), dim=0)
    tail = torch.cat([torch.flip(rev, dims=(0,))[1:],
                      torch.ones(1, dtype=torch.float32, device=T.device)])
    head = rev[-1]
    per_round = eta ** 2 * (b_term(T, m, cfg) + c_term(T, m, cfg))
    return head * cfg.delta1 + (per_round * tail).sum()


def objective_and_penalty(T: torch.Tensor, m: torch.Tensor, cfg: AnalysisConfig,
                          *, p1_cap: float = 0.2, penalty_weight: float = 1e4):
    """Objective + smooth penalties for the Problem-2 constraints:
    p_t^1 < p1_cap, m P_u (T_t - B_u)/T_t > 1 + margin, T_t > max_u B_u.
    Returns ``(penalized value, (objective, p1))``."""
    obj = theorem1_bound(T, m, cfg)
    p1 = p1_round(T, m, cfg)
    B = _f32(cfg.B_eff, T.device)
    m = _f32(m, T.device)
    pen = torch.sum(torch.relu(p1 - 0.9 * p1_cap) ** 2)
    frac = (T[:, None] - B[None, :]) / torch.clamp(T[:, None], min=_EPS)
    denom = m * _f32(cfg.P, T.device)[None, :] * frac - 1.0
    pen = pen + torch.sum(torch.relu(0.05 - denom) ** 2)
    pen = pen + torch.sum(torch.relu(B.max() * 1.05 - T) ** 2)
    return obj + penalty_weight * pen, (obj, p1)


def upload_bytes(cfg: AnalysisConfig, device="cpu") -> torch.Tensor:
    """Expected upload bytes per round, shape (R,): contributors * dense
    float32 payload (``cfg.bytes_full``) * wire ratio (``cfg.comm_scale``)."""
    return _u_vec(cfg, device) * cfg.bytes_full * cfg.comm_scale
