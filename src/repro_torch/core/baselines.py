"""Round policies: ADEL-FL and the paper's baselines (Section IV), in
PyTorch (port of ``repro.core.baselines``).

A policy decides, per round t: the deadline T_t (the simulated round
wall-clock), each client's batch size S_t^u, the per-(client, layer)
contribution mask, and the aggregation rule (bias-corrected layer-wise,
plain mean, or HeteroFL's width-overlap mean). ``round(draws, t, view=)``
plans against an optional per-round :class:`AnalysisConfig` *view* whose
``U``/``P``/``B`` describe the cohort actually sampled that round (the
fleet engine derives one per round); without one the policy plans against
the static config it was built with.

All randomness flows through the ``draws`` object the runtime passes to
:meth:`Policy.round` (:class:`repro_torch.fl.runtime.Draws`: ``poisson(t,
lam)`` and ``gamma(t, a, n)``), so runs are reproducible and tests can
inject the reference's own draws. Plans are (U,)/(L,)-sized host tensors.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from . import straggler
from .types import AnalysisConfig, Schedule

__all__ = ["RoundPlan", "Policy", "AdelPolicy", "SalfPolicy", "DropPolicy",
           "WaitPolicy", "HeteroFLPolicy", "make_policy"]


@dataclasses.dataclass
class RoundPlan:
    mask: torch.Tensor         # (U, L) layer contribution mask
    p: torch.Tensor            # (L,) zero-contributor probabilities (0 where unused)
    batch_sizes: torch.Tensor  # (U,)
    elapsed: float             # simulated wall-clock consumed by this round
    bias_correct: bool         # Eq. (5) 1/(1-p) correction?
    width_ratios: Optional[np.ndarray] = None   # HeteroFL only


class Policy:
    """Per-round decision maker: ``round(draws, t, view=None)`` plans
    round t, against ``view`` when given (see the module docstring)."""

    name: str = "base"

    def __init__(self, cfg: AnalysisConfig):
        self.cfg = cfg

    def round(self, draws, t: int,
              view: Optional[AnalysisConfig] = None
              ) -> RoundPlan:  # pragma: no cover
        raise NotImplementedError

    def _resolve(self, view: Optional[AnalysisConfig]) -> AnalysisConfig:
        return view if view is not None else self.cfg

    def _fixed_batch(self, view: Optional[AnalysisConfig], T: float):
        """Fixed-batch policies (salf/drop/wait): the cached S for the
        static population, re-derived from the cohort view otherwise."""
        if view is None:
            return self.S
        return straggler.fixed_batch(T, self.m, view)


class AdelPolicy(Policy):
    """ADEL-FL: Problem-2-optimized deadlines + B3 batch sizes + Eq. (5)."""

    name = "adel"

    def __init__(self, cfg: AnalysisConfig, schedule: Schedule):
        super().__init__(cfg)
        self.schedule = schedule

    def round(self, draws, t, view=None):
        T_t = float(self.schedule.T[t])
        mask, p, S, _ = straggler.sample_round(
            functools.partial(draws.poisson, t), T_t, self.schedule.m,
            self._resolve(view))
        return RoundPlan(mask=mask, p=p, batch_sizes=S, elapsed=T_t,
                         bias_correct=True)


class SalfPolicy(Policy):
    """SALF: layer-wise aggregation with bias correction, but a FIXED
    deadline T_max/R and one FIXED batch size for every user."""

    name = "salf"

    def __init__(self, cfg: AnalysisConfig, m: float):
        super().__init__(cfg)
        self.m = float(m)
        self.T_t = cfg.T_max / cfg.R
        self.S = straggler.fixed_batch(self.T_t, self.m, cfg)

    def round(self, draws, t, view=None):
        cfg = self._resolve(view)
        S_fix = self._fixed_batch(view, self.T_t)
        mask, p, _ = straggler.sample_round_fixed(
            functools.partial(draws.poisson, t), self.T_t, S_fix, cfg)
        S = torch.full((cfg.U,), S_fix)
        return RoundPlan(mask=mask, p=p, batch_sizes=S, elapsed=self.T_t,
                         bias_correct=True)


class DropPolicy(Policy):
    """Drop-Stragglers: fixed deadline; a client counts only if it finished
    the FULL model in time (z_u >= L); late clients are discarded."""

    name = "drop"

    def __init__(self, cfg: AnalysisConfig, m: float):
        super().__init__(cfg)
        self.m = float(m)
        self.T_t = cfg.T_max / cfg.R
        self.S = straggler.fixed_batch(self.T_t, self.m, cfg)

    def round(self, draws, t, view=None):
        cfg = self._resolve(view)
        S_fix = self._fixed_batch(view, self.T_t)
        P = torch.as_tensor(cfg.P, dtype=torch.float32)
        B = torch.as_tensor(cfg.B_eff, dtype=torch.float32)
        lam = P / S_fix * torch.clamp(self.T_t - B, min=0.0)
        z = draws.poisson(t, lam)
        full = (z >= cfg.L).to(torch.float32)                   # (U,)
        mask = full[:, None].expand(cfg.U, cfg.L).contiguous()
        S = torch.full((cfg.U,), S_fix)
        return RoundPlan(mask=mask, p=torch.zeros(cfg.L), batch_sizes=S,
                         elapsed=self.T_t, bias_correct=False)


class WaitPolicy(Policy):
    """Wait-Stragglers (synchronous FedAvg): no deadline; the round lasts
    until the slowest client finishes (max_u Gamma(L, S_u/P_u) + B_u), so
    far fewer rounds fit inside T_max."""

    name = "wait"

    def __init__(self, cfg: AnalysisConfig, m: float):
        super().__init__(cfg)
        self.m = float(m)
        self.T_ref = cfg.T_max / cfg.R
        self.S = straggler.fixed_batch(self.T_ref, self.m, cfg)

    def round(self, draws, t, view=None):
        cfg = self._resolve(view)
        S_fix = self._fixed_batch(view, self.T_ref)
        P = torch.as_tensor(cfg.P, dtype=torch.float32)
        B = torch.as_tensor(cfg.B_eff, dtype=torch.float32)
        # full backprop time = sum of L iid Exp(S/P) = Gamma(L, scale=S/P)
        g = draws.gamma(t, cfg.L, cfg.U) * (S_fix / P)
        elapsed = float(torch.max(g + B))
        mask = torch.ones((cfg.U, cfg.L), dtype=torch.float32)
        S = torch.full((cfg.U,), S_fix)
        return RoundPlan(mask=mask, p=torch.zeros(cfg.L), batch_sizes=S,
                         elapsed=elapsed, bias_correct=False)


class HeteroFLPolicy(Policy):
    """HeteroFL [30]: clients train width-reduced submodels matched to their
    capability; aggregation averages each parameter entry over the clients
    whose submodel contains it. Compute per layer scales ~ r^2 (both weight
    matrices shrink), so slow clients nearly always finish their small
    model. With a per-round cohort ``view`` (fleet runs) the capability
    buckets are re-derived from the sampled cohort's P.
    ``RoundPlan.width_ratios`` tells the runtime which width masks to
    build; the width-overlap mean runs on every execution backend
    (:mod:`repro_torch.fl.backends`)."""

    name = "heterofl"
    LEVELS = (1.0, 0.5, 0.25, 0.125)

    def __init__(self, cfg: AnalysisConfig, m: float):
        super().__init__(cfg)
        self.m = float(m)
        self.T_t = cfg.T_max / cfg.R
        self.ratios = self._capability_ratios(cfg.P)

    @classmethod
    def _capability_ratios(cls, P: np.ndarray) -> np.ndarray:
        """Capability-bucketed width ratios: fastest quartile -> 1.0, etc."""
        P = np.asarray(P)
        order = np.argsort(np.argsort(-P))          # rank 0 = fastest
        quart = (order * len(cls.LEVELS)) // len(P)
        return np.asarray([cls.LEVELS[q] for q in quart], np.float32)

    def round(self, draws, t, view=None):
        cfg = self._resolve(view)
        ratios = (self.ratios if view is None
                  else self._capability_ratios(cfg.P))
        P = torch.as_tensor(cfg.P, dtype=torch.float32)
        B = torch.as_tensor(cfg.B_eff, dtype=torch.float32)
        S_fix = straggler.fixed_batch(self.T_t, self.m, cfg)
        r = torch.as_tensor(ratios)
        # per-layer time Exp(S r^2 / P) -> completed layers
        # ~ Poisson(P (T - B) / (S r^2))
        lam = P / (S_fix * r ** 2) * torch.clamp(self.T_t - B, min=0.0)
        z = draws.poisson(t, lam)
        full = (z >= cfg.L).to(torch.float32)
        mask = full[:, None].expand(cfg.U, cfg.L).contiguous()
        S = torch.full((cfg.U,), S_fix)
        return RoundPlan(mask=mask, p=torch.zeros(cfg.L), batch_sizes=S,
                         elapsed=self.T_t, bias_correct=False,
                         width_ratios=ratios)

    def describe(self):
        return {"name": self.name, "m": self.m, "ratios": self.ratios.tolist()}


def make_policy(method: str, cfg: AnalysisConfig, *,
                schedule: Schedule | None = None, m: float | None = None,
                device=None) -> Policy:
    """``device`` is where a missing schedule (``adel``) or m is solved."""
    from .scheduler import constant_schedule, solve
    if method == "adel":
        if schedule is None:
            schedule = solve(cfg, "trust-constr", device=device)
        return AdelPolicy(cfg, schedule)
    if m is None:
        m = constant_schedule(cfg, device=device).m
    if method == "salf":
        return SalfPolicy(cfg, m)
    if method == "drop":
        return DropPolicy(cfg, m)
    if method == "wait":
        return WaitPolicy(cfg, m)
    if method == "heterofl":
        return HeteroFLPolicy(cfg, m)
    raise ValueError(f"unknown method {method!r}")
