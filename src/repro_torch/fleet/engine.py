"""``run_fleet``: the fleet-scale front end over the round runtime, in
PyTorch (port of ``repro.fleet.engine``).

``run_fleet`` decouples the *population* (up to millions of devices,
through the :class:`repro_torch.fleet.population.Population` protocol)
from the *cohort* (the ``U`` clients a round plans for):

1. it builds the Problem-2 planning config (:func:`reference_config`, from
   the population's ``plan_profile``) and the policy, and probes ``s_max``
   against the population's best-case device;
2. it wraps the population's per-round cohort draws and view derivation
   in a :class:`FleetCohortSource` and hands the loop to
   :class:`repro_torch.fl.runtime.RoundRuntime`.

Per round the population decides who is reachable and picks at most
``cohort_size`` devices (``Population.sample_cohort``); the source
re-derives the AnalysisConfig the policy sees (``profile_view``) and
stacks only the sampled cohort's shards at a fixed ``n_pad`` on the host,
then copies them to the run's device — never a ``(fleet, N, ...)`` array.
Device ids map onto data shards by ``id % len(parts)``, so a
million-device :class:`~repro_torch.fleet.population.ParametricPopulation`
trains against a bounded shard set at O(cohort) cost a round. The runtime
pads the cohort axis to the backend's width and runs the round on any
:mod:`repro_torch.fl.backends` backend: ``chunked`` (the default here),
``dense``, ``shard_map``, ``temporal``, ``buffered`` or ``hierarchical``
(edge-region partials fed by the cohort's region ids). Every one folds
through the grouped kernels.

The reference's ``run_fleet(model, fleet, availability, data)``
positional form remains as a deprecated alias resolved onto
``MaterializedPopulation`` (same trajectories; warns, or raises under
``REPRO_EXEC_STRICT=1``).
"""
from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.core.baselines import Policy, make_policy
from repro_torch.core.scheduler import solve
from repro_torch.core.types import AnalysisConfig
from repro_torch.device import resolve_device
from repro_torch.fl.partition import (dirichlet_partition, iid_partition,
                                      stack_clients)
from repro_torch.fl.runtime import Cohort, ModelAPI, RoundRuntime, probe_s_max
from repro_torch.fl.spec import ExecSpec
from repro_torch.fleet.availability import AvailabilityModel
from repro_torch.fleet.cohort import profile_view
from repro_torch.fleet.population import (MaterializedPopulation, Population,
                                          PopulationSpec, make_population)
from repro_torch.fleet.profiles import Fleet
from repro_torch.tree import tree_leaves

__all__ = ["FleetData", "FleetCohortSource", "partition_fleet",
           "reference_config", "run_fleet"]


def _legacy_fleet_shim(population, availability, data, *,
                       where: str) -> tuple:
    """Resolve the deprecated ``(fleet, availability, data)`` calling form
    onto a :class:`MaterializedPopulation` (warn; raise in strict mode)."""
    if isinstance(population, Fleet):
        msg = (f"{where}(model, fleet, availability, data) is deprecated; "
               f"pass a Population — e.g. MaterializedPopulation(fleet, "
               f"availability) or make_population(spec) — followed by data")
        if bool(os.environ.get("REPRO_EXEC_STRICT")):
            raise ValueError(f"{msg} (REPRO_EXEC_STRICT=1)")
        warnings.warn(msg, DeprecationWarning, stacklevel=3)
        population = MaterializedPopulation(population, availability)
        availability = None
    elif isinstance(population, (str, dict, PopulationSpec)):
        population = make_population(population)
    if availability is not None and data is None:
        # new positional form: (model, population, data)
        data, availability = availability, None
    if availability is not None:
        raise TypeError(f"{where}: availability is part of the Population "
                        f"(wrap it in MaterializedPopulation)")
    return population, data


@dataclasses.dataclass
class FleetData:
    """Dataset plus per-device shard indices (never stacked fleet-wide).

    ``parts[u]`` indexes device u's samples inside the shared ``x``/``y``
    arrays; only the per-round cohort is ever stacked as a
    ``(U, n_pad, ...)`` batch.
    """

    x: np.ndarray                 # (n, ...) training inputs
    y: np.ndarray                 # (n,) training labels
    parts: list                   # index arrays into x/y, one per shard
    x_test: np.ndarray
    y_test: np.ndarray

    @property
    def n_pad(self) -> int:
        return max(len(p) for p in self.parts)


def partition_fleet(x: np.ndarray, y: np.ndarray, x_test: np.ndarray,
                    y_test: np.ndarray, n_devices: int, *,
                    alpha: Optional[float] = 0.5, seed: int = 0) -> FleetData:
    """Split one dataset over ``n_devices`` shards (Dirichlet or IID)."""
    if alpha is None:
        parts = iid_partition(len(y), n_devices, seed=seed)
    else:
        parts = dirichlet_partition(y, n_devices, alpha=alpha, seed=seed)
    return FleetData(x=x, y=y, parts=parts, x_test=x_test, y_test=y_test)


def reference_config(population: Union[Population, Fleet], *, U: int, L: int,
                     R: int, T_max: float, eta0: float = 2.0,
                     eta_decay: float = 1.0, seed: int = 0) -> AnalysisConfig:
    """Planning config for the Problem-2 solver: a quantile-spaced
    representative cohort of the population (the schedule reflects the
    real P/B spread rather than one random draw). Accepts a
    :class:`~repro_torch.fleet.population.Population` or a bare
    :class:`Fleet` (the pick math is identical)."""
    if isinstance(population, Fleet):
        population = MaterializedPopulation(population)
    P, B = population.plan_profile(int(U))
    base = AnalysisConfig.default(U=U, L=L, R=R, T_max=T_max, eta0=eta0,
                                  eta_decay=eta_decay, seed=seed)
    return dataclasses.replace(base, P=P, B=B)


class FleetCohortSource:
    """Per-round population cohort draw -> policy view -> the sampled
    cohort's shards stacked at a fixed ``n_pad`` and copied to ``device``.

    Accepts any :class:`~repro_torch.fleet.population.Population`; the
    reference's ``FleetCohortSource(fleet, availability, data, ref)``
    positional form is a deprecated alias resolved onto
    ``MaterializedPopulation`` with identical draw sequences. Device ids
    index data shards modulo ``len(data.parts)``.
    """

    def __init__(self, population: Union[Population, Fleet],
                 availability: Optional[AvailabilityModel] = None,
                 data: Optional[FleetData] = None,
                 ref: Optional[AnalysisConfig] = None, *, cohort_size: int,
                 strategy: str = "uniform", seed: int = 0, device=None):
        if (not isinstance(population, Fleet)
                and isinstance(availability, FleetData) and ref is None):
            # new positional form (population, data, ref)
            availability, data, ref = None, availability, data
        population, data = _legacy_fleet_shim(population, availability, data,
                                              where="FleetCohortSource")
        self.population: Population = population
        self.data = data
        self.ref = ref
        self.cohort_size = int(cohort_size)
        self.strategy = strategy
        self.device = resolve_device(device)
        self.rng = np.random.default_rng([2077, seed])
        population.reset()

    @property
    def plan_rate_max(self) -> float:
        """Fastest compute rate any cohort can plan for: bounds a
        re-solve's m so batches stay within the probed ``s_max`` even when
        the fleet's fastest devices were offline at re-plan time."""
        return float(self.population.rate_max)

    def round_cohort(self, t: int) -> Optional[Cohort]:
        draw = self.population.sample_cohort(t, self.rng,
                                             U=self.cohort_size,
                                             strategy=self.strategy)
        if draw is None:
            return None
        view = profile_view(self.ref, draw.P, draw.B)
        n_parts = len(self.data.parts)
        xs, ys, counts = stack_clients(
            self.data.x, self.data.y,
            [self.data.parts[int(u) % n_parts] for u in draw.ids],
            n_pad=self.data.n_pad)
        dev = self.device
        return Cohort(x=torch.as_tensor(xs, device=dev),
                      y=torch.as_tensor(ys, device=dev),
                      counts=torch.as_tensor(counts, device=dev), view=view,
                      available=draw.available, regions=draw.region)

    # ------------------------------------------------------------------
    def replan_view(self, t: int, budget_left: float,
                    eta_tail) -> AnalysisConfig:
        """Remaining-horizon planning config re-estimated from the
        reachable population (the online re-planning hook).

        ``U_round`` carries the population's expected-reachable forecast
        for every remaining round (clipped to the plannable cohort size);
        ``U`` is its mean, and ``P``/``B`` come from
        ``Population.replan_profile``.
        """
        eta_tail = np.asarray(eta_tail, np.float32)
        rounds_left = len(eta_tail)
        exp = self.population.expected_reachable(t, rounds_left)
        U_round = np.clip(np.round(exp), 2.0,
                          float(self.cohort_size)).astype(np.float32)
        U_est = int(np.clip(round(float(U_round.mean())), 2,
                            self.cohort_size))
        P, B = self.population.replan_profile(U_est)
        sigma2 = np.full((U_est,), float(np.mean(self.ref.sigma2)),
                         np.float32)
        return dataclasses.replace(
            self.ref, U=U_est, R=rounds_left, T_max=float(budget_left),
            eta=eta_tail, P=P, B=B, sigma2=sigma2, U_round=U_round)


def _param_count(model: ModelAPI) -> int:
    """Parameter count from an init on the ``meta`` device (no memory is
    allocated for the params)."""
    params = model.init(torch.Generator().manual_seed(0), "meta")
    return sum(int(leaf.numel()) for leaf in tree_leaves(params))


def run_fleet(model: ModelAPI, population: Union[Population, Fleet, str,
                                                 dict, PopulationSpec] = None,
              availability: Optional[AvailabilityModel] = None,
              data: Optional[FleetData] = None, *,
              fleet: Optional[Fleet] = None,
              method: str = "adel", rounds: int = 20,
              cohort_size: int = 32, cohort_strategy: str = "uniform",
              exec: Optional[ExecSpec] = None,
              backend=None, chunk_size: Optional[int] = None, mesh=None,
              T_max: Optional[float] = None,
              eta0: float = 2.0, eta_decay: float = 1.0,
              solver: str = "adam", solver_steps: int = 600,
              local_iters: Optional[int] = None, l2: Optional[float] = None,
              s_max: Optional[int] = None, eval_every: int = 1,
              seed: int = 0, verbose: bool = False,
              replan=None, donate: Optional[bool] = None,
              compression=None, agg_impl: Optional[str] = None,
              tracer=None, init_params=None, draws=None,
              eval_metrics=None, device=None) -> tuple:
    """Run up to ``rounds`` federated rounds against a simulated population
    on ``device`` (the card unless the caller passes another).

    Returns ``(params, History)``; the History carries the fields of
    :func:`repro_torch.fl.server.run_federated` plus per-round reachable
    counts (``available``) and re-plan events (``replans``).

    WHO the rounds run against is one
    :class:`repro_torch.fleet.population.Population` —
    ``run_fleet(model, population, data)`` — or anything
    :func:`repro_torch.fleet.population.make_population` accepts (a source
    string such as ``"parametric:longtail-mobile"``, a dict, a
    ``PopulationSpec``). The reference's ``run_fleet(model, fleet,
    availability, data)`` form and the ``fleet=`` kwarg remain as
    deprecated aliases of ``MaterializedPopulation(fleet, availability)``.

    HOW rounds execute is one :class:`repro_torch.fl.spec.ExecSpec`
    (``exec=``), resolved against this front end's base spec
    (``backend="chunked"``, its chunk clamped to the cohort size); the
    ``backend`` / ``chunk_size`` / ``mesh`` / ``donate`` / ``compression``
    / ``agg_impl`` kwargs are aliases resolved through the same
    :meth:`ExecSpec.resolve`. Cohort region ids from the population take
    precedence over the hierarchical backend's ``regions`` fallback. The
    spec's ``compression`` is priced into the planning config
    (``comm_scale``) before solving.

    ``replan`` (None | trigger name | ``ReplanConfig``) enables
    availability-aware online re-solving (``method="adel"`` only).
    ``tracer`` records telemetry into ``History.telemetry``. ``draws`` and
    ``init_params`` are the draw seam of :meth:`RoundRuntime.run` (tests
    replay the reference's draws through them). ``eval_metrics``
    (``(model, params, test_x, test_y) -> (metric, loss)``, default the
    classification :func:`repro_torch.fl.runtime.eval_metrics`) swaps in
    the task's eval, e.g. :func:`repro_torch.fl.tasks.lm_eval_metrics`
    with :func:`repro_torch.fl.tasks.lm_fleet_data`.
    """
    if fleet is not None:
        if population is not None:
            raise TypeError("run_fleet: pass either population or the "
                            "deprecated fleet=, not both")
        population = fleet
    population, data = _legacy_fleet_shim(population, availability, data,
                                          where="run_fleet")
    if data is None or not len(data.parts):
        raise ValueError("run_fleet: data must be a FleetData with at least "
                         "one shard")
    dev = resolve_device(device)
    if T_max is None:
        # the paper benchmarks' calibration: average depth ~50% of layers
        T_max = rounds * model.L * 0.5

    spec = ExecSpec.resolve(exec, base=ExecSpec(backend="chunked"),
                            backend=backend, chunk_size=chunk_size,
                            mesh=mesh, local_iters=local_iters, l2=l2,
                            donate=donate, compression=compression,
                            agg_impl=agg_impl)
    if spec.backend == "chunked":
        spec = dataclasses.replace(
            spec, chunk_size=min(spec.chunk_size, cohort_size))

    ref = reference_config(population, U=cohort_size, L=model.L, R=rounds,
                           T_max=T_max, eta0=eta0, eta_decay=eta_decay,
                           seed=seed)
    comp = spec.compression
    if comp.mode != "none":
        # price the compressed wire into the planning config BEFORE
        # solving: every B_u shrinks by the wire ratio (B_eff), and
        # bytes_full (the dense f32 payload a client) feeds the
        # core.cost.upload_bytes diagnostic
        ref = dataclasses.replace(ref, comm_scale=comp.wire_scale(),
                                  bytes_full=4.0 * _param_count(model))
    schedule = None
    if method == "adel":
        schedule = solve(ref, solver, device=dev,
                         **({"steps": solver_steps} if solver == "adam"
                            else {}))
    policy: Policy = make_policy(method, ref, schedule=schedule, device=dev)

    if s_max is None:
        # probe against a synthetic best-case device (population-max P,
        # population-min B): ADEL's B3 batches grow with P_u and shrink
        # with B_u, and the baselines' fixed batch uses the cohort means,
        # so no realized cohort can plan a batch this bound would clip;
        # batches are drawn with replacement, so allow up to 4x the
        # largest shard
        P_best, B_best = population.best_profile()
        view_best = dataclasses.replace(
            ref, U=1, P=np.asarray([P_best], np.float32),
            B=np.asarray([B_best], np.float32),
            sigma2=np.asarray([float(np.mean(ref.sigma2))], np.float32))
        s_max = min(probe_s_max(policy, rounds, view=view_best),
                    4 * data.n_pad)
    s_max = max(s_max, 2)

    runtime = RoundRuntime(model, policy, exec=spec, tracer=tracer,
                           device=dev)
    source = FleetCohortSource(population, data=data, ref=ref,
                               cohort_size=cohort_size,
                               strategy=cohort_strategy, seed=seed,
                               device=dev)
    eval_fn = None
    if eval_metrics is not None:
        tx = torch.as_tensor(data.x_test, device=dev)
        ty = torch.as_tensor(data.y_test, device=dev)

        def eval_fn(params):
            return eval_metrics(model, params, tx, ty)
    return runtime.run(source, rounds=rounds, T_max=T_max, eta=ref.eta,
                       s_max=s_max, test_x=data.x_test, test_y=data.y_test,
                       seed=seed, eval_every=eval_every, verbose=verbose,
                       method=f"fleet-{policy.name}", replan=replan,
                       init_params=init_params, draws=draws,
                       eval_fn=eval_fn)
