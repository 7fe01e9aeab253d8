"""Regularized upper incomplete gamma function Q(s, x) for integer s, in
PyTorch (port of ``repro.core.gamma``).

For integer s >= 1 (the paper's Auxiliary Lemma, Appendix E)

    Q(s, x) = sum_{k=0}^{s-1} x^k e^{-x} / k!   (= P[Poisson(x) <= s-1]).

ADEL-FL evaluates Q(L+1-l, T_t/m) for every layer l in 1..L, so the whole
ladder s = 1..L comes out of one cumulative log-sum-exp pass (stable for
large x, differentiable in x through autograd).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["q_gamma", "q_gamma_all", "log_q_gamma_all", "poisson_cdf",
           "layer_q", "p_no_contributor", "q_inv"]


def _log_poisson_pmf_terms(kmax: int, x: torch.Tensor) -> torch.Tensor:
    """log of x^k e^{-x}/k! for k = 0..kmax-1; shape x.shape + (kmax,)."""
    x = x.to(torch.float32)[..., None]
    k = torch.arange(kmax, dtype=torch.float32, device=x.device)
    # k*log(x) with the k=0, x=0 corner handled (0*log 0 -> 0)
    safe_log = torch.where(x > 0, torch.log(torch.clamp(x, min=1e-38)),
                           torch.full_like(x, -float("inf")))
    klogx = torch.where(k == 0, torch.zeros_like(safe_log), k * safe_log)
    return klogx - x - torch.lgamma(k + 1.0)


def log_q_gamma_all(smax: int, x: torch.Tensor) -> torch.Tensor:
    """log Q(s, x) for s = 1..smax; shape x.shape + (smax,)."""
    terms = _log_poisson_pmf_terms(smax, x)
    return torch.clamp(torch.logcumsumexp(terms, dim=-1), max=0.0)


def q_gamma_all(smax: int, x: torch.Tensor) -> torch.Tensor:
    """Q(s, x) for s = 1..smax (shape x.shape + (smax,))."""
    return torch.exp(log_q_gamma_all(smax, x))


def q_gamma(s: int, x: torch.Tensor) -> torch.Tensor:
    """Scalar-s Q(s, x) = P[Poisson(x) <= s-1]."""
    return q_gamma_all(int(s), x)[..., -1]


def poisson_cdf(k: int, lam: torch.Tensor) -> torch.Tensor:
    """P[Poisson(lam) <= k] = Q(k+1, lam); k >= 0 integer."""
    return q_gamma(int(k) + 1, lam)


def layer_q(L: int, x: torch.Tensor) -> torch.Tensor:
    """q[l-1] = Q(L+1-l, x) for l = 1..L; shape x.shape + (L,). Layer L
    (output side, reached first by backprop) gets Q(1, x) = e^{-x}."""
    return torch.flip(q_gamma_all(L, x), dims=(-1,))


def p_no_contributor(L: int, x: torch.Tensor, U: int) -> torch.Tensor:
    """Lemma 1 bound: p_t^l <= Q(L+1-l, x)^U, for l = 1..L."""
    logq = torch.flip(log_q_gamma_all(L, x), dims=(-1,))
    return torch.exp(U * logq)


def q_inv(s: int, target: float, *, iters: int = 80) -> float:
    """Solve Q(s, x) = target for x (Q is decreasing in x) by bisection.

    The Problem-2 solver turns the Lemma-3 validity constraint
    Q(L, T_t/m)^U < cap into the floor T_t >= m * q_inv(L, cap**(1/U)).
    A host-side scalar computation, evaluated in float32 on the CPU.
    """
    target = float(np.clip(target, 1e-30, 1.0 - 1e-12))
    lo, hi = 0.0, float(s + 20.0 * np.sqrt(s) + 50.0)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        x = torch.tensor(mid, dtype=torch.float32, device="cpu")
        if float(q_gamma(s, x)) > target:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)
