"""The ``Population`` protocol: fleet size as a parameter, not an array
(port of ``repro.fleet.population``; numpy only, and bit-for-bit the
reference's draws: device profiles are pure in the device id through the
same splitmix64 / Box-Muller hashing).

The original fleet surface materialized one ``(n,)`` row per device
(:class:`repro_torch.fleet.profiles.Fleet`) and evaluated availability over the
WHOLE population every round, capping simulations at thousands of
devices. The Problem-2 solver, however, only ever consumes cohort-level
``(P_u, B_u)`` statistics — so this module makes the population an
*interface* with two implementations:

* :class:`MaterializedPopulation` — wraps today's ``Fleet`` arrays plus an
  :class:`repro_torch.fleet.availability.AvailabilityModel` **bit-for-bit**: the
  per-round RNG consumption is one availability step and one cohort
  draw from the caller's stream, so scenario trajectories reproduce
  exactly.
* :class:`ParametricPopulation` — draws device profiles *lazily* from
  per-tier distributions fitted to a small reference draw of the preset
  (its ``P_q05_50_95``/``B_q05_50_95`` quantiles), and evaluates
  availability analytically for the sampled cohort only. Per-round cost
  is O(cohort): no array anywhere is sized by the fleet, so
  ``size=1_000_000`` costs the same per round as ``size=10_000``.

Construction funnels through :class:`PopulationSpec` /
:func:`make_population`, the population analogue of
:class:`repro_torch.fl.spec.ExecSpec`: a frozen spec with ``resolve`` /
``add_cli_args`` / ``from_cli`` so ``python -m repro_torch.fleet.scenarios``
shares the reference's ``--population`` flag block. Source forms::

    "longtail-mobile"              # materialized preset draw
    "trace:PATH"                   # materialized JSON device trace
    "mobiperf:PATH"                # materialized MobiPerf measurement log
    "parametric:longtail-mobile"   # lazy million-device sampling

``regions`` partitions every sampled cohort into edge regions (device id
mod ``regions``); the ids flow through :class:`repro_torch.fl.runtime.Cohort`
into the ``hierarchical`` execution backend's two-tier region -> global
aggregation fold (:class:`repro_torch.fl.backends.HierarchicalBackend`).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import warnings
from typing import Optional

import numpy as np

from repro_torch.fleet.availability import (AVAILABILITY, AlwaysOn,
                                      AvailabilityModel, make_availability)
from repro_torch.fleet.cohort import COHORT_STRATEGIES, _stratified, sample_cohort
from repro_torch.fleet.profiles import (PRESETS, Fleet, load_mobiperf, load_trace,
                                  make_fleet)

__all__ = ["CohortDraw", "Population", "MaterializedPopulation",
           "ParametricPopulation", "PopulationSpec", "make_population"]

# z-score of the 0.95 quantile of the standard normal: the two-piece
# lognormal fits pin (q05, q50, q95) exactly through this constant
_Z95 = 1.6448536269514722


@dataclasses.dataclass(frozen=True)
class CohortDraw:
    """One round's sampled cohort: device ids + their profiles.

    ``region`` is the edge-region id of every cohort member (``ids %
    population.regions``) or ``None`` when the population is flat — it
    rides :class:`repro_torch.fl.runtime.Cohort` into the hierarchical backend.
    """

    ids: np.ndarray                       # (U,) int64 device ids
    P: np.ndarray                         # (U,) float32 compute rates (B1)
    B: np.ndarray                         # (U,) float32 network times (B2)
    tier: np.ndarray                      # (U,) int32 memory tiers
    available: int                        # reachable-device count this round
    region: Optional[np.ndarray] = None   # (U,) int32 edge-region ids

    @property
    def size(self) -> int:
        return int(self.ids.shape[0])


class Population:
    """Protocol for device populations: everything ``run_fleet`` needs.

    Implementations answer per-round cohort draws and cohort-level
    planning statistics WITHOUT promising per-device arrays — fleet size
    is a parameter. The contract:

    * ``size`` — number of simulated devices.
    * ``regions`` — edge-region count for hierarchical aggregation
      (device id mod ``regions``; 1 = flat).
    * ``sample_cohort(t, rng, U=, strategy=)`` — availability draw +
      cohort pick for round ``t``; returns a :class:`CohortDraw` or
      ``None`` when nobody is reachable. ``rng`` is the CALLER's cohort
      stream (``default_rng([2077, seed])`` in ``FleetCohortSource``) so
      draw sequences stay bit-compatible with the reference.
    * ``plan_profile(U)`` — quantile-spaced representative ``(P, B)``
      arrays for the Problem-2 planning config
      (:func:`repro_torch.fleet.engine.reference_config`).
    * ``replan_profile(U)`` — like ``plan_profile`` but conditioned on
      the most recent availability information (the online re-planning
      hook).
    * ``best_profile()`` — ``(P_max, B_min)`` of the population, for the
      ``s_max`` memory probe.
    * ``expected_reachable(t0, horizon)`` — expected reachable counts for
      the next ``horizon`` rounds (re-planning forecasts).
    * ``rate_max`` — fastest plannable compute rate.
    * ``plan_stats()`` / ``describe()`` — quantile summaries.
    * ``reset()`` — rewind any availability state.
    """

    regions: int = 1

    @property
    def size(self) -> int:  # pragma: no cover - interface
        raise NotImplementedError

    def sample_cohort(self, t: int, rng: np.random.Generator, *, U: int,
                      strategy: str = "uniform") -> Optional[CohortDraw]:
        raise NotImplementedError  # pragma: no cover - interface

    def plan_profile(self, U: int) -> tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError  # pragma: no cover - interface

    def replan_profile(self, U: int) -> tuple[np.ndarray, np.ndarray]:
        return self.plan_profile(U)

    def best_profile(self) -> tuple[float, float]:
        raise NotImplementedError  # pragma: no cover - interface

    def expected_reachable(self, t0: int, horizon: int = 1) -> np.ndarray:
        raise NotImplementedError  # pragma: no cover - interface

    @property
    def rate_max(self) -> float:
        return float(self.best_profile()[0])

    def reset(self) -> None:
        pass

    def describe(self) -> dict:  # pragma: no cover - interface
        raise NotImplementedError

    def plan_stats(self) -> dict:
        """Cohort-planning quantile summary (P/B q05/q50/q95 + tiers)."""
        return self.describe()["fleet"]

    def _region_ids(self, ids: np.ndarray) -> Optional[np.ndarray]:
        if self.regions <= 1:
            return None
        return (np.asarray(ids, np.int64) % self.regions).astype(np.int32)


class MaterializedPopulation(Population):
    """Today's ``Fleet`` arrays + availability model behind ``Population``.

    Per round: one ``availability.step(t)`` over the full fleet, then one
    :func:`repro_torch.fleet.cohort.sample_cohort` draw from the caller's
    RNG, the reference's sequence bit for bit.
    Memory and per-round cost stay O(fleet); use
    :class:`ParametricPopulation` beyond ~10^5 devices.
    """

    def __init__(self, fleet: Fleet,
                 availability: Optional[AvailabilityModel] = None, *,
                 regions: int = 1):
        if availability is None:
            availability = AlwaysOn(fleet.size)
        if availability.n != fleet.size:
            raise ValueError(
                f"availability model over {availability.n} devices != fleet "
                f"size {fleet.size}")
        self.fleet = fleet
        self.availability = availability
        self.regions = max(int(regions), 1)
        self._last_avail: Optional[np.ndarray] = None

    @property
    def size(self) -> int:
        return self.fleet.size

    def reset(self) -> None:
        self.availability.reset()
        self._last_avail = None

    def sample_cohort(self, t: int, rng: np.random.Generator, *, U: int,
                      strategy: str = "uniform") -> Optional[CohortDraw]:
        avail = self.availability.step(t)
        self._last_avail = avail
        idx = sample_cohort(rng, avail, self.fleet, int(U), strategy)
        if len(idx) == 0:
            return None
        ids = np.asarray(idx, np.int64)
        return CohortDraw(ids=ids, P=self.fleet.P[idx], B=self.fleet.B[idx],
                          tier=self.fleet.tier[idx],
                          available=int(avail.sum()),
                          region=self._region_ids(ids))

    def plan_profile(self, U: int) -> tuple[np.ndarray, np.ndarray]:
        q = (np.arange(U) + 0.5) / U
        order = np.argsort(self.fleet.P)
        pick = order[np.clip((q * self.fleet.size).astype(int), 0,
                             self.fleet.size - 1)]
        return self.fleet.P[pick].copy(), self.fleet.B[pick].copy()

    def replan_profile(self, U: int) -> tuple[np.ndarray, np.ndarray]:
        """Quantile-spaced over the devices reachable in the current round
        (falling back to the whole fleet before the first draw)."""
        pool = (np.flatnonzero(self._last_avail)
                if self._last_avail is not None and self._last_avail.any()
                else np.arange(self.fleet.size))
        q = (np.arange(U) + 0.5) / U
        order = pool[np.argsort(self.fleet.P[pool])]
        pick = order[np.clip((q * len(order)).astype(int), 0,
                             len(order) - 1)]
        return self.fleet.P[pick].copy(), self.fleet.B[pick].copy()

    def best_profile(self) -> tuple[float, float]:
        return float(self.fleet.P.max()), float(self.fleet.B.min())

    def expected_reachable(self, t0: int, horizon: int = 1) -> np.ndarray:
        return self.availability.expected_reachable(t0, horizon)

    def describe(self) -> dict:
        return {"fleet": self.fleet.describe(),
                "availability": self.availability.describe(),
                "regions": self.regions}


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer: uint64 array -> uint64 array."""
    x = x + np.uint64(0x9E3779B97F4A7C15)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def _hash_uniform(h: np.ndarray, stream: int) -> np.ndarray:
    """One U(0,1) double per element from hash state ``h`` and a stream id."""
    mixed = _splitmix64(h ^ np.uint64(0xD6E8FEB86659FD93 * (stream + 1)
                                      & 0xFFFFFFFFFFFFFFFF))
    return (mixed >> np.uint64(11)).astype(np.float64) * (2.0 ** -53)


def _box_muller(u1: np.ndarray, u2: np.ndarray) -> np.ndarray:
    u1 = np.maximum(u1, 1e-300)
    return np.sqrt(-2.0 * np.log(u1)) * np.cos(2.0 * np.pi * u2)


@dataclasses.dataclass(frozen=True)
class _TwoPieceLogNormal:
    """Lognormal with separate spread below/above the median.

    ``mu = ln q50``; ``sigma_lo``/``sigma_hi`` are chosen so the fitted
    q05 and q95 equal the reference draw's — all three recorded quantiles
    match by construction, which is what the parametric-fidelity contract
    tests. Samples clip to the reference draw's observed [min, max].
    """

    mu: float
    sigma_lo: float
    sigma_hi: float
    lo: float
    hi: float

    @classmethod
    def fit(cls, vals: np.ndarray) -> "_TwoPieceLogNormal":
        q05, q50, q95 = np.quantile(vals, [0.05, 0.5, 0.95])
        mu = float(np.log(q50))
        return cls(mu=mu,
                   sigma_lo=max((mu - float(np.log(max(q05, 1e-12)))) / _Z95,
                                0.0),
                   sigma_hi=max((float(np.log(q95)) - mu) / _Z95, 0.0),
                   lo=float(vals.min()), hi=float(vals.max()))

    def sample(self, z: np.ndarray) -> np.ndarray:
        sigma = np.where(z < 0.0, self.sigma_lo, self.sigma_hi)
        return np.clip(np.exp(self.mu + sigma * z),
                       self.lo, self.hi).astype(np.float32)

    def quantiles(self) -> list:
        return [round(float(np.clip(np.exp(self.mu + s * z), self.lo,
                                    self.hi)), 4)
                for z, s in ((-_Z95, self.sigma_lo), (0.0, 0.0),
                             (_Z95, self.sigma_hi))]


class ParametricPopulation(Population):
    """Million-device populations with O(cohort) per-round cost.

    Instead of materializing ``(n,)`` profile arrays, the population keeps
    a small *reference draw* of the preset (``min(size, ref_size)``
    devices, same ``(preset, seed)`` determinism as :func:`make_fleet`)
    and fits, per memory tier, a :class:`_TwoPieceLogNormal` to ``P`` and
    ``B`` — pinning exactly the ``P_q05_50_95``/``B_q05_50_95`` quantiles
    of the reference draw. Everything per round is then
    cohort-sized:

    * **profiles** — device ``u``'s ``(tier, P_u, B_u)`` is a pure
      function of ``(seed, u)``: a vectorized splitmix64 hash yields the
      device's uniforms, Box-Muller turns them into the tier-conditional
      lognormal draws. Any device can be profiled on demand, and the same
      device always gets the same profile — no per-device state.
    * **availability** — the churn model's *marginal* rate ``r(t)``
      (:meth:`repro_torch.fleet.availability.AvailabilityModel.marginal_rate`)
      prices reachability analytically: the reachable count is one
      ``Binomial(size, r(t))`` draw, and cohort membership is uniform
      over devices (per-device availability is exchangeable under the
      marginal model — Markov stickiness and per-device diurnal phases
      are deliberately averaged out; use :class:`MaterializedPopulation`
      when those correlations matter).
    * **cohort ids** — distinct ids come from rejection sampling
      (``rng.integers`` + ``np.unique`` top-up), never an O(size)
      permutation.

    All three cohort strategies work: ``power-of-choice`` and
    ``stratified`` profile an oversampled candidate pool lazily and
    select within it.
    """

    def __init__(self, preset: str, size: int, *, seed: int = 0,
                 availability: str = "always-on", availability_kwargs=(),
                 regions: int = 1, ref_size: int = 4096):
        if preset not in PRESETS:
            raise ValueError(f"unknown fleet preset {preset!r}; registered "
                             f"presets: {sorted(PRESETS)}")
        if availability not in AVAILABILITY:
            raise ValueError(
                f"unknown availability model {availability!r}; known: "
                f"{sorted(AVAILABILITY)}")
        self.preset = preset
        self._size = int(size)
        self.seed = int(seed)
        self.regions = max(int(regions), 1)
        self.availability_name = availability
        self.availability_kwargs = dict(availability_kwargs)
        self._avail_cls = AVAILABILITY[availability]
        self._ref = make_fleet(preset, min(self._size, int(ref_size)),
                               seed=seed)
        fracs = np.bincount(self._ref.tier, minlength=3) / self._ref.size
        self._tier_cum = np.cumsum(fracs)
        self._fit_P = [(_TwoPieceLogNormal.fit(self._ref.P[self._ref.tier == k])
                        if fracs[k] > 0 else None) for k in range(3)]
        self._fit_B = [(_TwoPieceLogNormal.fit(self._ref.B[self._ref.tier == k])
                        if fracs[k] > 0 else None) for k in range(3)]
        self._seed_hash = _splitmix64(
            np.asarray([seed], np.uint64) ^ np.uint64(0xA0761D6478BD642F))[0]

    @property
    def size(self) -> int:
        return self._size

    def _rate(self, t: int) -> float:
        return self._avail_cls.marginal_rate(t, **self.availability_kwargs)

    def profiles(self, ids) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Deterministic lazy profiles ``(P, B, tier)`` for device ids."""
        ids = np.asarray(ids, np.uint64)
        h = _splitmix64(ids ^ self._seed_hash)
        tier = np.searchsorted(self._tier_cum, _hash_uniform(h, 0),
                               side="right").astype(np.int32)
        tier = np.minimum(tier, 2)
        zP = _box_muller(_hash_uniform(h, 1), _hash_uniform(h, 2))
        zB = _box_muller(_hash_uniform(h, 3), _hash_uniform(h, 4))
        P = np.empty(len(ids), np.float32)
        B = np.empty(len(ids), np.float32)
        for k in range(3):
            sel = tier == k
            if not sel.any():
                continue
            fit_P, fit_B = self._fit_P[k], self._fit_B[k]
            if fit_P is None:            # empty reference tier: remap to the
                tier[sel] = 1            # middle tier's fit (never selected
                fit_P, fit_B = self._fit_P[1], self._fit_B[1]  # in practice)
            P[sel] = fit_P.sample(zP[sel])
            B[sel] = fit_B.sample(zB[sel])
        return P, B, tier

    def _distinct_ids(self, rng: np.random.Generator, k: int) -> np.ndarray:
        """``k`` distinct uniform device ids in O(k), never O(size)."""
        n = self._size
        if k >= n:
            return np.arange(n, dtype=np.int64)
        ids = np.unique(rng.integers(0, n, size=k + (k >> 2) + 8))
        while len(ids) < k:
            ids = np.unique(np.concatenate(
                [ids, rng.integers(0, n, size=k)]))
        if len(ids) > k:
            ids = np.sort(rng.choice(ids, size=k, replace=False))
        return ids.astype(np.int64)

    def sample_cohort(self, t: int, rng: np.random.Generator, *, U: int,
                      strategy: str = "uniform") -> Optional[CohortDraw]:
        r = float(np.clip(self._rate(t), 0.0, 1.0))
        available = int(rng.binomial(self._size, r)) if r > 0 else 0
        if available == 0:
            return None
        U = int(U)
        U_eff = min(U, available)
        if strategy == "uniform":
            ids = self._distinct_ids(rng, U_eff)
        elif strategy == "power-of-choice":
            k = min(available, 2 * U, self._size)
            cand = self._distinct_ids(rng, k)
            P_c, _, _ = self.profiles(cand)
            ids = np.sort(cand[np.argsort(-P_c)[:U_eff]])
        elif strategy == "stratified":
            k = min(available, max(4 * U_eff, U_eff), self._size)
            cand = self._distinct_ids(rng, k)
            _, _, tier_c = self.profiles(cand)
            pos = _stratified(rng, np.arange(len(cand)), tier_c, U_eff)
            ids = np.sort(cand[pos])
        else:
            raise ValueError(f"unknown cohort strategy {strategy!r}; "
                             f"known: {COHORT_STRATEGIES}")
        P, B, tier = self.profiles(ids)
        return CohortDraw(ids=ids, P=P, B=B, tier=tier, available=available,
                          region=self._region_ids(ids))

    def plan_profile(self, U: int) -> tuple[np.ndarray, np.ndarray]:
        """Quantile-spaced representative cohort over the reference draw
        (the same pick math as the materialized path, so planning configs
        agree between a preset's parametric and materialized forms)."""
        q = (np.arange(U) + 0.5) / U
        order = np.argsort(self._ref.P)
        pick = order[np.clip((q * self._ref.size).astype(int), 0,
                             self._ref.size - 1)]
        return self._ref.P[pick].copy(), self._ref.B[pick].copy()

    def best_profile(self) -> tuple[float, float]:
        # lazy draws clip to the reference draw's [min, max], so the
        # reference extremes bound every profile the population can emit
        return float(self._ref.P.max()), float(self._ref.B.min())

    def expected_reachable(self, t0: int, horizon: int = 1) -> np.ndarray:
        return np.asarray([self._size * float(np.clip(self._rate(t0 + k),
                                                      0.0, 1.0))
                           for k in range(horizon)])

    def describe(self) -> dict:
        fracs = np.diff(np.concatenate([[0.0], self._tier_cum]))
        fleet = {"name": f"parametric:{self.preset}", "size": self._size,
                 "P_q05_50_95": self._ref.describe()["P_q05_50_95"],
                 "B_q05_50_95": self._ref.describe()["B_q05_50_95"],
                 "tiers": [int(round(f * self._size)) for f in fracs]}
        avail = {"name": self.availability_name, "n": self._size,
                 "analytic": True, **self.availability_kwargs}
        return {"fleet": fleet, "availability": avail,
                "regions": self.regions}


_PFIELDS = ("source", "size", "availability", "availability_kwargs",
            "regions", "seed")
_SOURCE_FORMS = ("PRESET", "trace:PATH", "mobiperf:PATH", "parametric:PRESET")


@dataclasses.dataclass(frozen=True)
class PopulationSpec:
    """One immutable value describing WHO a simulation runs against.

    The population analogue of :class:`repro_torch.fl.spec.ExecSpec`:
    front ends (``run_fleet``, ``repro_torch.fleet.scenarios``) accept a
    spec plus per-field kwargs, funnel both through :meth:`resolve`, and
    share one CLI flag block via
    :meth:`add_cli_args` / :meth:`from_cli`.
    """

    source: str = "uniform"          # preset | trace:/mobiperf: | parametric:
    size: int = 500
    availability: str = "always-on"
    availability_kwargs: tuple = ()  # tuple of (key, value) pairs (hashable)
    regions: int = 1                 # edge regions (device id mod regions)
    seed: int = 0

    def __post_init__(self):
        if isinstance(self.availability_kwargs, dict):
            object.__setattr__(self, "availability_kwargs",
                               tuple(sorted(self.availability_kwargs.items())))
        if self.regions < 1:
            raise ValueError(f"regions must be >= 1, got {self.regions}")

    # -- resolution (mirrors ExecSpec.resolve) --------------------------
    @classmethod
    def resolve(cls, spec: Optional["PopulationSpec"] = None, *,
                base: Optional["PopulationSpec"] = None,
                **legacy) -> "PopulationSpec":
        """Overlay non-None legacy kwargs on ``spec`` (or ``base``)."""
        unknown = set(legacy) - set(_PFIELDS)
        if unknown:
            raise TypeError(f"unknown population kwargs {sorted(unknown)}; "
                            f"fields: {_PFIELDS}")
        out = spec if spec is not None else (base or cls())
        overrides = {k: v for k, v in legacy.items() if v is not None}
        if overrides:
            out = dataclasses.replace(out, **overrides)
        return out

    def validate(self, *, strict: Optional[bool] = None) -> "PopulationSpec":
        """Flag spec values the resolved population cannot honour.

        Warns by default; raises when ``strict`` (default: the
        ``REPRO_EXEC_STRICT`` env toggle, shared with ``ExecSpec``)."""
        if strict is None:
            strict = bool(os.environ.get("REPRO_EXEC_STRICT"))
        issues = []
        kind, _, arg = self.source.partition(":")
        if kind in ("trace", "mobiperf"):
            if not arg:
                issues.append(f"source {self.source!r} is missing its PATH")
            elif self.size != type(self).size:
                issues.append(f"size={self.size} is ignored for "
                              f"{kind}: sources (the file fixes the size)")
        if self.availability not in AVAILABILITY:
            issues.append(f"unknown availability model "
                          f"{self.availability!r}; known: "
                          f"{sorted(AVAILABILITY)}")
        if issues:
            msg = "PopulationSpec: " + "; ".join(issues)
            if strict:
                raise ValueError(msg + " (REPRO_EXEC_STRICT=1)")
            warnings.warn(msg, UserWarning, stacklevel=3)
        return self

    # -- construction ---------------------------------------------------
    def build(self, *, avail_seed: Optional[int] = None) -> Population:
        """Materialize/instantiate the population this spec describes.

        ``avail_seed`` optionally decouples the availability stream's seed
        from the profile seed (scenario front-ends seed availability with
        ``fc.seed + run_seed``, as the reference does).
        """
        kind, _, arg = self.source.partition(":")
        seed_a = self.seed if avail_seed is None else int(avail_seed)
        if kind == "parametric":
            if arg not in PRESETS:
                raise ValueError(
                    f"unknown parametric preset {arg!r}; registered presets: "
                    f"{sorted(PRESETS)}")
            return ParametricPopulation(
                arg, self.size, seed=self.seed,
                availability=self.availability,
                availability_kwargs=self.availability_kwargs,
                regions=self.regions)
        if kind == "trace" and arg:
            fleet = load_trace(arg)
        elif kind == "mobiperf" and arg:
            fleet = load_mobiperf(arg)
        elif self.source in PRESETS:
            fleet = make_fleet(self.source, self.size, seed=self.seed)
        else:
            raise ValueError(
                f"unknown population source {self.source!r}; expected one of "
                f"{_SOURCE_FORMS} with PRESET in {sorted(PRESETS)}")
        avail = make_availability(self.availability, fleet.size, seed=seed_a,
                                  **dict(self.availability_kwargs))
        return MaterializedPopulation(fleet, avail, regions=self.regions)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    # -- the shared CLI flag block (mirrors ExecSpec.add_cli_args) ------
    @staticmethod
    def add_cli_args(parser: argparse.ArgumentParser) -> None:
        """Install the shared ``--population`` flag block. All defaults are
        None so :meth:`from_cli` only overrides what the user set."""
        g = parser.add_argument_group(
            "population", "device population (repro_torch.fleet.population); "
                          "unset flags keep the front-end's resolved spec")
        g.add_argument("--population", default=None, metavar="SRC",
                       help="population source: a fleet preset "
                            f"({', '.join(sorted(PRESETS))}), 'trace:PATH', "
                            "'mobiperf:PATH', or 'parametric:PRESET' "
                            "(lazy profiles, million-device scale)")
        g.add_argument("--fleet-size", type=int, default=None,
                       help="number of simulated devices")
        g.add_argument("--availability", default=None,
                       choices=sorted(AVAILABILITY),
                       help="availability/churn model")
        g.add_argument("--regions", type=int, default=None,
                       help="edge regions for hierarchical two-tier "
                            "aggregation (device id mod regions; 1 = flat)")

    @classmethod
    def from_cli(cls, args: argparse.Namespace, *,
                 base: Optional["PopulationSpec"] = None) -> "PopulationSpec":
        return cls.resolve(base=base, source=args.population,
                           size=args.fleet_size,
                           availability=args.availability,
                           regions=args.regions).validate()


def make_population(spec, *, size: Optional[int] = None,
                    seed: Optional[int] = None,
                    availability: Optional[str] = None,
                    availability_kwargs=None,
                    regions: Optional[int] = None,
                    avail_seed: Optional[int] = None) -> Population:
    """One factory for every population form (the ``spec`` front door).

    ``spec`` may be a :class:`Population` (returned as-is), a
    :class:`~repro_torch.fleet.profiles.Fleet` (wrapped in a
    :class:`MaterializedPopulation`, availability built from the
    ``availability``/``availability_kwargs`` overrides), a
    :class:`PopulationSpec`, a dict of spec fields, or a source string
    (``"longtail-mobile"``, ``"trace:PATH"``, ``"mobiperf:PATH"``,
    ``"parametric:PRESET"``). Non-None keyword overrides overlay the spec
    via :meth:`PopulationSpec.resolve`.
    """
    if isinstance(spec, Population):
        return spec
    if isinstance(spec, Fleet):
        n_regions = 1 if regions is None else int(regions)
        avail = make_availability(availability or "always-on", spec.size,
                                  seed=(avail_seed if avail_seed is not None
                                        else (seed or 0)),
                                  **dict(availability_kwargs or {}))
        return MaterializedPopulation(spec, avail, regions=n_regions)
    if isinstance(spec, PopulationSpec):
        base = spec
    elif isinstance(spec, dict):
        base = PopulationSpec(**spec)
    elif isinstance(spec, str):
        base = PopulationSpec(source=spec)
    else:
        raise TypeError(f"make_population: unsupported spec type "
                        f"{type(spec).__name__}; expected Population, Fleet, "
                        f"PopulationSpec, dict, or source string")
    base = PopulationSpec.resolve(
        base=base, size=size, seed=seed, availability=availability,
        availability_kwargs=(tuple(sorted(availability_kwargs.items()))
                             if isinstance(availability_kwargs, dict)
                             else availability_kwargs),
        regions=regions)
    return base.build(avail_seed=avail_seed)
