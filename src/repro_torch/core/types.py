"""Shared dataclasses for the ADEL-FL core.

A numpy-only copy of ``repro.core.types``: the port keeps its own copy so
that it never imports the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class AnalysisConfig:
    """Constants of the Theorem-1 convergence bound / Problem-2 objective.

    Mirrors Table I of the paper.
    """

    U: int                      # number of users
    L: int                      # number of DNN layers
    R: int                      # number of global rounds (R1)
    T_max: float                # total training-time budget (R2)
    eta: np.ndarray             # learning-rate schedule, shape (R,)
    rho_c: float                # strong-convexity constant (A1)
    rho_s: float                # smoothness constant (A1)
    sigma2: np.ndarray          # per-user gradient-variance bounds sigma_u^2, shape (U,) (A2)
    G2: float                   # squared gradient-norm bound G^2 (A3)
    het_gap: float              # heterogeneity gap Gamma, Eq. (6)
    P: np.ndarray               # per-user compute capability P_u, shape (U,) (B1)
    B: np.ndarray               # per-user communication time B_u, shape (U,) (B2)
    delta1: float = 1.0         # Delta_1 = E||w_1 - w_opt||^2
    # Availability-aware planning (beyond-paper, repro_torch.core.replan): the
    # EXPECTED plannable cohort size per round, shape (R,). When set, the
    # Theorem-1 terms evaluate round t at U_round[t] contributors (C_t's
    # Q^U truncation, B_t's 1/U^2 averaging) while P/B/sigma2 keep
    # describing a U-sized representative capability spread. None keeps the
    # paper's static-U objective exactly.
    U_round: Optional[np.ndarray] = None
    # Bytes-on-the-wire pricing (repro_torch.core.compression): ``comm_scale``
    # multiplies every B_u — the per-user communication time B2 prices the
    # dense float32 delta upload, and compressing the payload shrinks it by
    # the wire ratio (0.25 for int8, ~1.25*top_k for topk8). All model-side
    # consumers (B_t variance term, B3 batch sizes, solver feasibility,
    # straggler clock draws) read ``B_eff`` so the Problem-2 solver trades
    # batch size against upload bytes consistently. ``bytes_full`` records
    # the dense float32 payload size per client (diagnostic; 0 = unknown).
    comm_scale: float = 1.0
    bytes_full: float = 0.0

    @property
    def B_eff(self) -> np.ndarray:
        """Effective per-user communication time: ``B * comm_scale``."""
        return self.B * np.float32(self.comm_scale)

    def __post_init__(self):
        object.__setattr__(self, "eta", np.asarray(self.eta, np.float32))
        object.__setattr__(self, "sigma2", np.asarray(self.sigma2, np.float32))
        object.__setattr__(self, "P", np.asarray(self.P, np.float32))
        object.__setattr__(self, "B", np.asarray(self.B, np.float32))
        assert self.eta.shape == (self.R,), (self.eta.shape, self.R)
        assert self.sigma2.shape == (self.U,)
        assert self.P.shape == (self.U,)
        assert self.B.shape == (self.U,)
        assert self.comm_scale > 0.0
        if self.U_round is not None:
            u = np.asarray(self.U_round, np.float32)
            object.__setattr__(self, "U_round", u)
            assert u.shape == (self.R,), (u.shape, self.R)
            assert float(u.min()) >= 2.0, "per-round cohorts need >= 2 users"

    @staticmethod
    def default(U: int, L: int, R: int, T_max: float, *,
                eta0: float = 0.1, eta_decay: float = 1.0, seed: int = 0,
                het_spread: float = 4.0,
                base_rate: float = 8.0) -> "AnalysisConfig":
        """A reasonable default with heterogeneous P_u spread.

        ``base_rate`` scales every P_u (samples/sec per layer).  The straggler
        depth statistics are invariant to this scale (lambda_t^u = T_t/m under
        B3), but the *batch sizes* S_t^u = m P_u (1 - B_u/T_t) grow with it —
        real edge devices process many samples/sec, and batch sizes of 1-2
        make SGD needlessly noisy without changing the scheduling math.

        ``eta_decay`` generalizes the paper's inverse decay to
        eta_t = eta0 / (1 + eta_decay * t) (the same family; eta_decay=1
        reproduces the paper's eta0/(1+t); deep models on few rounds need a
        slower decay to make any progress — recorded in EXPERIMENTS.md).
        """
        rng = np.random.default_rng(seed)
        t = np.arange(1, R + 1, dtype=np.float32)
        eta = eta0 / (1.0 + eta_decay * t)
        P = base_rate * np.exp(
            rng.uniform(0.0, np.log(het_spread), size=U)).astype(np.float32)
        B = rng.uniform(0.005, 0.02, size=U).astype(np.float32) * (T_max / R)
        sigma2 = np.full((U,), 1.0, np.float32)
        return AnalysisConfig(
            U=U, L=L, R=R, T_max=float(T_max), eta=eta,
            rho_c=0.1, rho_s=2.0, sigma2=sigma2, G2=1.0, het_gap=0.1,
            P=P, B=B, delta1=1.0,
        )


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Output of the Problem-2 solver: the ADEL-FL round configuration."""

    T: np.ndarray               # per-round deadlines T_t^d, shape (R,), nonincreasing
    m: float                    # global batch-scaling parameter
    objective: float            # achieved Theorem-1 bound value
    p1: np.ndarray              # per-round p_t^1 (layer-1 zero-contributor prob bound)
    solver: str = "adam"

    def batch_sizes(self, cfg: AnalysisConfig) -> np.ndarray:
        """Model Formulation B3: S_t^u = floor(m P_u (T_t - B_u)/T_t), shape
        (R, U). ``B_u`` is the EFFECTIVE communication time (``cfg.B_eff``):
        a compressed wire leaves more of the deadline for compute, so the
        planned batches grow."""
        T = self.T[:, None]
        B = cfg.B_eff
        S = np.floor(self.m * cfg.P[None, :] * (T - B[None, :]) / T)
        return np.maximum(S, 1.0).astype(np.int32)
