"""Online re-planning of the remaining-horizon Problem 2 under churn (port
of ``repro.core.replan``).

The static pipeline solves Problem 2 once, against a fixed population
view. When availability churn shifts the reachable population mid-run,
the Lemma-3 feasibility construction the schedule was solved under no
longer describes the rounds being executed: with a smaller cohort ``U``
the layer-1 zero-contributor bound ``p_t^1 = Q(L, T_t/m)^U`` grows.

:class:`Replanner` closes the loop online:

* a **trigger policy** (:class:`ReplanConfig`) decides *when* to re-solve:
  ``never`` (the static baseline), ``every-k`` rounds, or ``drift`` when
  the reachable-device count moves past a relative threshold since the
  last (re-)plan;
* the **remaining-horizon problem** (rounds ``R - t``, budget
  ``T_max - elapsed``, the learning-rate tail, and a population view
  re-estimated from the reachable fleet by
  :meth:`repro_torch.fleet.engine.FleetCohortSource.replan_view`) is
  solved by **warm-starting** :func:`repro_torch.core.scheduler.solve_adam`
  from the tail of the incumbent schedule
  (:func:`repro_torch.core.scheduler.invert_schedule`), so a mid-run
  re-solve costs a few hundred Adam steps;
* the re-solved tail is **spliced** into the policy's full-length schedule
  (consumed rounds keep their historical deadlines).

The runtime hook lives in :meth:`repro_torch.fl.runtime.RoundRuntime.run`,
so every execution backend and both front ends (``run_federated`` /
``run_fleet``) re-plan identically; each re-solve is recorded in
``History.replans``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

# .scheduler (and with it torch's solver) is imported lazily inside
# Replanner.replan, so repro_torch.configs.base can embed ReplanConfig in
# FleetConfig cheaply.
from .types import AnalysisConfig, Schedule

__all__ = ["TRIGGERS", "ReplanConfig", "ReplanEvent", "Replanner",
           "make_replan", "remaining_horizon"]

TRIGGERS = ("never", "every-k", "drift")


@dataclasses.dataclass(frozen=True)
class ReplanConfig:
    """When and how to re-solve the remaining-horizon Problem 2.

    ``trigger``: ``never`` | ``every-k`` | ``drift``. ``every`` is the
    every-k period; ``drift_threshold`` the relative reachable-count change
    (against the last plan) that trips the drift trigger. ``steps`` bounds
    the warm-started Adam re-solve. A tail shorter than
    ``min_rounds_left`` rounds is not re-solved.
    """

    trigger: str = "never"
    every: int = 4
    drift_threshold: float = 0.25
    steps: int = 300
    min_rounds_left: int = 2

    def __post_init__(self):
        if self.trigger not in TRIGGERS:
            raise ValueError(f"unknown replan trigger {self.trigger!r}; "
                             f"known: {TRIGGERS}")

    @property
    def active(self) -> bool:
        return self.trigger != "never"


def make_replan(spec) -> Optional[ReplanConfig]:
    """Normalize ``None`` / trigger-name string / ReplanConfig."""
    if spec is None or isinstance(spec, ReplanConfig):
        return spec
    if isinstance(spec, str):
        return ReplanConfig(trigger=spec)
    raise TypeError(f"replan must be None, a trigger name, or ReplanConfig; "
                    f"got {type(spec).__name__}")


@dataclasses.dataclass
class ReplanEvent:
    """One mid-run re-solve, as recorded in ``History.replans``."""

    round: int                 # round index t the re-plan took effect at
    reachable: int             # reachable-device count that triggered it
    U_est: int                 # re-estimated plannable cohort size
    budget_left: float         # T_max - elapsed at re-plan time
    T_tail: list               # re-solved deadlines for rounds t..R-1
    m: float                   # re-solved global batch-scaling parameter
    objective: float           # Theorem-1 bound of the re-solved tail
    steps: int                 # warm-start Adam steps spent
    # deadline budget credited back from rounds skipped (empty cohort)
    # since the previous (re-)plan; already part of budget_left
    skipped_credit: float = 0.0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def remaining_horizon(cfg: AnalysisConfig, t: int, budget_left: float,
                      eta_tail: np.ndarray) -> AnalysisConfig:
    """``cfg`` restricted to rounds ``t..R-1`` with the unspent budget."""
    u_tail = None if cfg.U_round is None else cfg.U_round[t:]
    return dataclasses.replace(cfg, R=cfg.R - t, T_max=float(budget_left),
                               eta=np.asarray(eta_tail, np.float32),
                               U_round=u_tail)


class Replanner:
    """Trigger bookkeeping, warm-started re-solve and schedule splice.

    Owned by :meth:`repro_torch.fl.runtime.RoundRuntime.run`; it keeps the
    reachable count of the last (re-)plan and the deadline budget credited
    back from skipped empty rounds (:meth:`note_skip`: a pending credit
    forces the next ``should_replan`` to fire). The policy must be
    schedule-driven (ADEL): re-planning replaces ``policy.schedule``, so
    the next ``policy.round`` reads the new tail. The re-solve runs on
    ``device`` (the card unless the caller passes another).
    """

    def __init__(self, cfg: ReplanConfig, policy, rounds: int,
                 eta: np.ndarray, s_max: Optional[int] = None,
                 rate_max: Optional[float] = None, device=None):
        if not hasattr(policy, "schedule"):
            raise ValueError(
                f"re-planning requires a schedule-driven policy (adel); "
                f"got {getattr(policy, 'name', type(policy).__name__)!r}")
        self.cfg = cfg
        self.policy = policy
        self.rounds = int(rounds)
        self.eta = np.asarray(eta, np.float32)
        # the runtime padded minibatches to s_max probed against the
        # INITIAL schedule, so a re-solve keeps the largest plannable batch
        # (~ m * max P_u) within it
        self.s_max = s_max
        self.rate_max = None if rate_max is None else float(rate_max)
        self.device = device
        self.ref_reachable: Optional[int] = None
        self.events: list[ReplanEvent] = []
        # budget credited back from skipped empty rounds since the last
        # (re-)plan; a pending credit forces a re-solve at the next
        # executed round
        self.skipped_credit: float = 0.0
        self._skip_pending: bool = False

    # ------------------------------------------------------------------
    def note_skip(self, t: int) -> float:
        """Round ``t`` never started (empty cohort): credit its unspent
        deadline back. The round's historical deadline is zeroed in the
        schedule and a re-solve is forced at the next executed round,
        whose ``budget_left = T_max - elapsed`` then includes the credit.
        Returns the credited deadline."""
        sch: Schedule = self.policy.schedule
        T = np.asarray(sch.T, np.float64).copy()
        if not 0 <= t < len(T):
            return 0.0
        credited = float(T[t])
        T[t] = 0.0
        self.policy.schedule = dataclasses.replace(sch, T=T)
        self.skipped_credit += credited
        self._skip_pending = True
        return credited

    # ------------------------------------------------------------------
    def should_replan(self, t: int, reachable: int) -> bool:
        if self.ref_reachable is None:
            self.ref_reachable = int(reachable)   # round-0 plan reference
            return False
        if t == 0 or self.rounds - t < max(self.cfg.min_rounds_left, 2):
            return False
        if self._skip_pending:
            # stranded budget from skipped rounds: re-allocate it now,
            # whatever the trigger's cadence says
            return True
        if self.cfg.trigger == "every-k":
            return t % max(self.cfg.every, 1) == 0
        if self.cfg.trigger == "drift":
            rel = abs(reachable - self.ref_reachable) / max(
                self.ref_reachable, 1)
            return rel > self.cfg.drift_threshold
        return False

    # ------------------------------------------------------------------
    def replan(self, t: int, budget_left: float, reachable: int,
               view: Optional[AnalysisConfig] = None) -> ReplanEvent:
        """Re-solve rounds ``t..R-1`` and splice the tail into the policy.

        ``view`` is the remaining-horizon AnalysisConfig (re-estimated from
        the reachable population by the cohort source); ``None`` restricts
        the policy's own config to the remaining horizon.
        """
        from .scheduler import invert_schedule, solve_adam

        old: Schedule = self.policy.schedule
        budget_left = max(float(budget_left), 1e-6)
        if view is None:
            view = remaining_horizon(self.policy.cfg, t, budget_left,
                                     self.eta[t:self.rounds])
        # bound against the FASTEST device the run can plan for (the
        # population-wide rate when the source exposes it), matching the
        # best-case device the s_max probe assumed
        P_fast = max(float(np.max(view.P)),
                     self.rate_max if self.rate_max is not None else 0.0)
        m_max = (None if self.s_max is None
                 else float(self.s_max) / P_fast)
        theta0 = invert_schedule(view, old.T[t:], old.m, m_max=m_max)
        sch = solve_adam(view, steps=self.cfg.steps, theta0=theta0,
                         m_max=m_max, device=self.device)
        # splice: consumed rounds keep their historical record
        T = np.concatenate([np.asarray(old.T[:t], np.float64), sch.T])
        p1 = np.concatenate([np.asarray(old.p1[:t], np.float64), sch.p1])
        self.policy.schedule = Schedule(T=T, m=sch.m, objective=sch.objective,
                                        p1=p1, solver=f"{sch.solver}-replan")
        self.ref_reachable = int(reachable)
        credit, self.skipped_credit = self.skipped_credit, 0.0
        self._skip_pending = False
        ev = ReplanEvent(round=t, reachable=int(reachable), U_est=int(view.U),
                         budget_left=float(budget_left),
                         T_tail=[float(x) for x in sch.T],
                         m=float(sch.m), objective=float(sch.objective),
                         steps=int(self.cfg.steps),
                         skipped_credit=float(credit))
        self.events.append(ev)
        return ev
