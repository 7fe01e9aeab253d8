"""Problem-2 solver: jointly optimize the per-round deadlines {T_t^d} and
the global batch-scaling parameter m (port of ``repro.core.scheduler``).

* ``solve_trust_region`` — scipy ``trust-constr`` as in the paper
  (Section III-C), fed exact autograd gradients, with linear constraints
  for the time budget and monotonicity and a nonlinear one for p_t^1 < 0.2.
* ``solve_adam`` — the reference's hand-written Adam on an unconstrained
  parameterization (nonincreasing deadlines that use the whole budget by
  construction; penalties for the other constraints), with the same
  constants and best-value tracking. ``jax.value_and_grad`` becomes
  autograd.

Both return a :class:`repro_torch.core.types.Schedule`. The objective runs
in float32 on ``device`` (the card unless the caller passes another).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from .cost import objective_and_penalty, p1_round, theorem1_bound
from .gamma import q_inv
from .types import AnalysisConfig, Schedule

__all__ = ["solve_adam", "solve_trust_region", "solve", "solve_rounds",
           "constant_schedule", "invert_schedule"]


# ---------------------------------------------------------------------------
# Parameterization: theta in R^{R+1} -> (T, m), feasible by construction:
#   * T nonincreasing, sum T = T_max (uses the full budget)
#   * p_t^1 = Q(L, T_t/m)^U <= p1_cap for every t, via the hard floor
#     T_t >= m * x_min with x_min = q_inv(L, p1_cap^(1/U))  (Lemma 3 validity)
#   * m in (m_min, m_cap], m_cap = T_max / (R * x_min) so the floor fits
# ---------------------------------------------------------------------------

def _x_min(cfg: AnalysisConfig, p1_cap: float = 0.2,
           margin: float = 0.9) -> float:
    # under a per-round availability forecast the SMALLEST expected cohort
    # binds (its floor is the largest), so it is applied to every round
    U_eff = cfg.U if cfg.U_round is None else float(np.min(cfg.U_round))
    return q_inv(cfg.L, (margin * p1_cap) ** (1.0 / U_eff))


def _m_cap(cfg: AnalysisConfig, x_min: float, m_max: float | None) -> float:
    """Upper bound for m: the floor-fits-budget cap, optionally tightened by
    an executable-batch bound ``m_max``."""
    cap = cfg.T_max / (cfg.R * max(x_min, 1e-9)) if x_min > 0 else np.inf
    if m_max is not None:
        cap = min(cap, float(m_max))
    return cap


def _theta_to_Tm(theta: torch.Tensor, cfg: AnalysisConfig, m_min: float = 1.0,
                 x_min: float = 0.0, m_max: float | None = None):
    # m in (m_min, m_cap]: sigmoid-bounded so R * m * x_min <= T_max
    m_cap = _m_cap(cfg, x_min, m_max)
    if np.isfinite(m_cap) and m_cap > m_min:
        m = m_min + (m_cap - m_min) * torch.sigmoid(theta[cfg.R])
    else:  # budget too tight for the cap at m_min: pin m
        m = torch.tensor(m_min, dtype=torch.float32, device=theta.device)
    # per-round feasibility floor; an instance infeasible even at m_min
    # falls back to the uniform allocation
    floor = torch.clamp(m * x_min, max=cfg.T_max / cfg.R)
    e = torch.nn.functional.softplus(theta[: cfg.R])       # (R,) >= 0
    b = torch.flip(torch.cumsum(torch.flip(e, (0,)), 0), (0,))   # nonincreasing
    extra = cfg.T_max - cfg.R * floor                       # budget above floor
    T = floor + extra * b / torch.clamp(b.sum(), min=1e-9)
    return T, m


def _invert_m(m: float, m_min: float, m_cap: float) -> tuple[np.ndarray, float]:
    """theta_m reproducing ``m`` under the sigmoid bound of
    :func:`_theta_to_Tm`, plus the m the parameterization realizes."""
    if np.isfinite(m_cap) and m_cap > m_min:
        frac = np.clip((m - m_min) / (m_cap - m_min), 1e-4, 1 - 1e-4)
        theta_m = np.asarray([np.log(frac / (1 - frac))], np.float32)
        m_eff = m_min + (m_cap - m_min) * float(frac)
    else:
        theta_m = np.zeros((1,), np.float32)
        m_eff = m_min
    return theta_m, m_eff


def _init_theta(cfg: AnalysisConfig, m0: float, m_min: float = 1.0,
                x_min: float = 0.0, m_max: float | None = None) -> np.ndarray:
    # start from the uniform allocation T_t = T_max / R and m = m0
    theta_T = np.full((cfg.R,), np.log(np.expm1(1.0)), np.float32)
    theta_m, _ = _invert_m(m0, m_min, _m_cap(cfg, x_min, m_max))
    return np.concatenate([theta_T, theta_m])


def _default_m0(cfg: AnalysisConfig) -> float:
    """Initial m aiming the per-round Poisson rate T_t/m at ~L."""
    return max(1.5, (cfg.T_max / cfg.R) / max(cfg.L, 1))


def _default_m_min(cfg: AnalysisConfig) -> float:
    """Smallest m keeping every batch size S_t^u >= ~2 (A2/B3)."""
    return 2.0 / float(cfg.P.min())


def invert_schedule(cfg: AnalysisConfig, T, m: float, *,
                    m_min: float | None = None,
                    m_max: float | None = None) -> np.ndarray:
    """Map a target ``(T, m)`` onto the solver's theta parameterization
    (float32 numpy, ready for ``solve_adam(theta0=...)``). ``T`` is
    rescaled onto ``cfg.T_max`` and ``m`` clipped into ``(m_min, m_cap]``."""
    m_min = _default_m_min(cfg) if m_min is None else m_min
    x_min = _x_min(cfg)
    T = np.asarray(T, np.float64)
    assert T.shape == (cfg.R,), (T.shape, cfg.R)
    theta_m, m_eff = _invert_m(m, m_min, _m_cap(cfg, x_min, m_max))
    # only the ratios of b above the floor matter: normalize to sum R
    floor = min(m_eff * x_min, cfg.T_max / cfg.R)
    b = np.maximum(T - floor, 1e-6)
    b = np.maximum.accumulate(b[::-1])[::-1]        # enforce nonincreasing T
    b = b / b.sum() * cfg.R
    e = np.maximum(b - np.concatenate([b[1:], [0.0]]), 1e-4)
    theta_T = np.log(np.expm1(e)).astype(np.float32)
    return np.concatenate([theta_T, theta_m])


def _schedule(cfg: AnalysisConfig, T: np.ndarray, m: float, solver: str,
              device: torch.device) -> Schedule:
    T = np.ascontiguousarray(T, np.float64)
    Tt = torch.as_tensor(T, dtype=torch.float32, device=device)
    mt = torch.tensor(m, dtype=torch.float32, device=device)
    with torch.no_grad():
        p1 = p1_round(Tt, mt, cfg).cpu().numpy()
        obj = float(theorem1_bound(Tt, mt, cfg))
    return Schedule(T=T, m=m, objective=obj, p1=p1, solver=solver)


def solve_adam(cfg: AnalysisConfig, *, steps: int = 3000, lr: float = 3e-2,
               m0: float | None = None, m_min: float | None = None,
               theta0=None, m_max: float | None = None,
               device=None) -> Schedule:
    dev = resolve_device(device)
    m0 = _default_m0(cfg) if m0 is None else m0
    m_min = _default_m_min(cfg) if m_min is None else m_min
    x_min = _x_min(cfg)
    theta = torch.as_tensor(
        _init_theta(cfg, m0, m_min, x_min, m_max) if theta0 is None
        else np.asarray(theta0, np.float32), dtype=torch.float32, device=dev)

    def value_and_grad(th: torch.Tensor):
        th = th.detach().requires_grad_(True)
        T, m = _theta_to_Tm(th, cfg, m_min, x_min, m_max)
        val, _ = objective_and_penalty(T, m, cfg)
        (g,) = torch.autograd.grad(val, th)
        return val.detach(), g

    # Adam state
    mu = torch.zeros_like(theta)
    nu = torch.zeros_like(theta)
    b1, b2, eps = 0.9, 0.999, 1e-8

    best = (np.inf, theta)
    for i in range(steps):
        val, g = value_and_grad(theta)
        mu = b1 * mu + (1 - b1) * g
        nu = b2 * nu + (1 - b2) * g * g
        mhat = mu / (1 - b1 ** (i + 1))
        nhat = nu / (1 - b2 ** (i + 1))
        theta = theta - lr * mhat / (torch.sqrt(nhat) + eps)
        # as in the reference: the pre-update value keys the updated theta
        v = float(val)
        if v < best[0]:
            best = (v, theta)
    with torch.no_grad():
        T, m = _theta_to_Tm(best[1], cfg, m_min, x_min, m_max)
    return _schedule(cfg, T.cpu().numpy().astype(np.float64), float(m),
                     "adam", dev)


def solve_trust_region(cfg: AnalysisConfig, *, m0: float | None = None,
                       m_min: float | None = None, maxiter: int = 300,
                       device=None) -> Schedule:
    """The paper's solver: scipy trust-constr on x = [T_1..T_R, m]."""
    import warnings

    from scipy.optimize import LinearConstraint, NonlinearConstraint, minimize

    dev = resolve_device(device)
    m0 = _default_m0(cfg) if m0 is None else m0
    m_min = _default_m_min(cfg) if m_min is None else m_min
    R = cfg.R
    Bmax = float(cfg.B_eff.max())

    def as_t(x, grad=False):
        return torch.tensor(np.asarray(x), dtype=torch.float32, device=dev,
                            requires_grad=grad)

    def fun(x):
        xt = as_t(x, grad=True)
        val, _ = objective_and_penalty(xt[:R], xt[R], cfg, penalty_weight=0.0)
        (g,) = torch.autograd.grad(val, xt)
        return float(val.detach()), g.cpu().numpy().astype(np.float64)

    def p1_fn(xt):
        return p1_round(xt[:R], xt[R], cfg)

    def p1_val(x):
        with torch.no_grad():
            return p1_fn(as_t(x)).cpu().numpy().astype(np.float64)

    def p1_jac(x):
        J = torch.autograd.functional.jacobian(p1_fn, as_t(x))
        return J.cpu().numpy().astype(np.float64)

    # sum T <= T_max  and  T_{t+1} - T_t <= 0
    A_sum = np.zeros((1, R + 1)); A_sum[0, :R] = 1.0
    A_mono = np.zeros((R - 1, R + 1))
    for t in range(R - 1):
        A_mono[t, t + 1] = 1.0
        A_mono[t, t] = -1.0
    lc = [LinearConstraint(A_sum, -np.inf, cfg.T_max),
          LinearConstraint(A_mono, -np.inf, 0.0)]
    nc = NonlinearConstraint(p1_val, -np.inf, 0.2 - 1e-3, jac=p1_jac)

    x0 = np.concatenate([np.full(R, cfg.T_max / R), [m0]])
    lb = np.concatenate([np.full(R, Bmax * 1.05 + 1e-6), [m_min]])
    ub = np.concatenate([np.full(R, cfg.T_max), [np.inf]])
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="delta_grad == 0.0")
        res = minimize(fun, x0, jac=True, method="trust-constr",
                       constraints=lc + [nc], bounds=list(zip(lb, ub)),
                       options={"maxiter": maxiter, "verbose": 0})
    T = np.maximum.accumulate(res.x[:R][::-1])[::-1]  # snap tiny violations
    return _schedule(cfg, T, float(res.x[R]), "trust-constr", dev)


def constant_schedule(cfg: AnalysisConfig, *, m: float | None = None,
                      device=None) -> Schedule:
    """The naive baseline allocation: T_t = T_max/R with a fixed m (used by
    the Drop-Stragglers / SALF baselines)."""
    dev = resolve_device(device)
    T = np.full((cfg.R,), cfg.T_max / cfg.R, np.float64)
    m = _default_m0(cfg) if m is None else m
    return _schedule(cfg, T, float(m), "constant", dev)


def solve_rounds(cfg: AnalysisConfig, method: str = "adam",
                 r_grid: Sequence[int] | None = None,
                 **kw) -> tuple[Schedule, AnalysisConfig]:
    """Beyond-paper extension (paper §III-D): also choose the NUMBER of
    rounds R, by solving the inner problem on a grid of R values and keeping
    the R with the smallest Theorem-1 bound. Returns (best schedule, the
    AnalysisConfig at the chosen R)."""
    if r_grid is None:
        base = cfg.R
        r_grid = sorted({max(2, r) for r in
                         (base // 4, base // 2, (3 * base) // 4, base,
                          (3 * base) // 2, 2 * base)})
    eta1 = float(cfg.eta[0])
    best = None
    for r in r_grid:
        t = np.arange(1, r + 1, dtype=np.float32)
        eta = (eta1 * 2.0) / (1.0 + t)       # same inverse-decay family
        cfg_r = dataclasses.replace(cfg, R=int(r), eta=eta)
        sch = solve(cfg_r, method, **kw)
        if best is None or sch.objective < best[0].objective:
            best = (sch, cfg_r)
    return best


def solve(cfg: AnalysisConfig, method: str = "trust-constr", *,
          device=None, **kw) -> Schedule:
    if method in ("trust-constr", "trust_region", "paper"):
        return solve_trust_region(cfg, device=device, **kw)
    if method == "adam":
        return solve_adam(cfg, device=device, **kw)
    if method == "constant":
        return constant_schedule(cfg, device=device, **kw)
    raise ValueError(f"unknown solver {method!r}")
