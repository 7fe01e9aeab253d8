"""The federated round loop, in PyTorch (port of ``repro.fl.runtime``).

:class:`RoundRuntime` owns per-round policy planning, minibatch sampling,
cohort padding to the backend's width (padded rows carry an all-zero mask,
batch weights and data, so they contribute nothing), HeteroFL width-mask
derivation (cached per distinct width-ratio vector), the simulated
wall-clock under Requirements R1 (at most R rounds) and R2 (total
simulated time <= T_max), online re-planning (:mod:`repro_torch.core.
replan`, including crediting the unspent deadline of skipped empty rounds
back to the next re-solve), eval cadence and the :class:`History` record.
WHO a round runs against is a cohort source: the same pre-stacked clients
every round (:class:`StaticCohortSource`) or a population draw
(:class:`repro_torch.fleet.engine.FleetCohortSource`, whose cohorts carry
their own planning view, reachable count and edge-region ids). HOW a
round executes is an :class:`repro_torch.fl.backends.ExecutionBackend`
(``dense`` / ``chunked`` / ``shard_map`` / ``temporal`` / ``buffered`` /
``hierarchical``), selected through one :class:`repro_torch.fl.spec.
ExecSpec`.

Every random draw of a run comes from one :class:`Draws` object: the
initial params, each round's Poisson depths (and the Wait baseline's Gamma
clocks) and each round's minibatch indices, drawn at the unpadded cohort
width so every backend sees the same minibatches. By default it is a
``torch.Generator`` seeded from ``seed``. The reference's JAX draws cannot
be reproduced by a torch generator, so tests pass a draw source of their
own that replays the reference's key sequence, plus ``init_params``.

The round loop runs in one of two modes (``ExecSpec.pipeline``), with
bit-identical trajectories:

* ``"serial"`` (default): plan round t, execute round t, repeat.
* ``"prefetch"``: a one-round lookahead. The sequential planner
  (``cohort``, the replan trigger and re-solve, the policy's ``plan``, the
  ``T_max`` stop check, the minibatch draws and the ``stack``) of round
  t+1 runs on one worker thread while round t runs. After a skipped round
  or a replan the next round is planned inline on the main thread: those
  rounds change the planning state the speculation would have to guess.
  The planner reads only host state and the planned clock, never a result
  of round t, and once the initial params are drawn the worker is the
  only consumer of the draws, so the speculation is exact. On a CUDA
  device the worker issues its gathers on a side stream; the main stream
  waits on an event recorded after them, and each stacked tensor is
  marked as used by the main stream, so the caching allocator
  does not hand its memory on while round t+1 still reads it. HeteroFL's
  width masks read the live params and stay on the main thread. Before
  round 0 the backend runs one round and one eval on zero params
  (:meth:`repro_torch.fl.backends.ExecutionBackend.warm_up`), so the
  first measured round does not pay one-off set-up.

Eval never blocks the host in either mode: accuracy stays an int64
correct-count on the device and the loss a device scalar, until a report
boundary (an active tracer's eval record, an ``on_round`` hook, the end of
the run) converts them; accuracy is then divided in Python's double, so
``History`` holds the same floats as a blocking eval would.

Observability flows through the single ``tracer=`` hook
(:mod:`repro_torch.obs`, default :data:`repro_torch.obs.NULL_TRACER` —
bit-identical trajectories): the runtime emits the ``cohort`` /
``replan`` / ``plan`` / ``stack`` / ``eval`` spans (the backends add
``local_train`` / ``aggregate``; the planner's spans are timed where it
runs and emitted on the main thread, as the tracer's sinks are not
thread-safe), the ``batch_elements_real`` / ``batch_elements_padded`` /
``h2d_bytes`` / ``rounds_skipped`` / ``replan_solver_steps`` counters and
the ``cohort_size`` gauge, one ``replan`` event per re-solve, and one
clock-model ledger event per executed round
(:func:`repro_torch.obs.ledger.round_record`); under prefetch also the
``warm_up`` span and the ``prefetch_rounds``, ``prefetch_overlap_s``
(worker planning time hidden behind the previous
round's dispatch), ``dispatch_wait_s`` (main-thread stalls on the worker)
and ``warm_up_s`` counters. The summary lands in ``History.telemetry``. On
a CUDA device an active tracer synchronizes at the end of the backend's
spans, of each round and of each eval.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.baselines import Policy, RoundPlan
from repro_torch.core.replan import Replanner, make_replan
from repro_torch.device import resolve_device, sync
from repro_torch.fl.backends import make_backend
from repro_torch.fl.client import sample_client_batches
from repro_torch.fl.spec import ExecSpec
from repro_torch.tree import tree_map

PyTree = Any

__all__ = ["ModelAPI", "History", "Cohort", "StaticCohortSource",
           "RoundContext", "Draws", "RoundRuntime", "probe_s_max",
           "DeviceRatio", "evaluate", "eval_metrics"]


@dataclasses.dataclass
class ModelAPI:
    """Minimal model interface consumed by the FL runtime.

    ``init(gen, device)`` draws the initial params from a
    ``torch.Generator``; ``loss(params, x, y, w)``; ``predict(params, x)``;
    ``layer_ids(params)`` maps each leaf to its layer (see
    :mod:`repro_torch.core.aggregation`).
    """

    init: Callable[[torch.Generator, Any], PyTree]
    loss: Callable[[PyTree, torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]
    predict: Callable[[PyTree, torch.Tensor], torch.Tensor]
    layer_ids: Callable[[PyTree], PyTree]
    L: int
    name: str = "model"
    # HeteroFL: width_masks(params, ratios (U,)) -> pytree with leading U
    # axis, on the params' device
    width_masks: Optional[Callable[[PyTree, np.ndarray], PyTree]] = None


@dataclasses.dataclass
class History:
    times: list = dataclasses.field(default_factory=list)
    rounds: list = dataclasses.field(default_factory=list)
    accuracy: list = dataclasses.field(default_factory=list)
    deadlines: list = dataclasses.field(default_factory=list)
    train_loss: list = dataclasses.field(default_factory=list)
    # fleet runs only: reachable-device count per evaluated round
    available: list = dataclasses.field(default_factory=list)
    # online re-planning only: one record per mid-run re-solve
    replans: list = dataclasses.field(default_factory=list)
    method: str = ""
    # tracer-enabled runs only: the run's telemetry summary — per-phase
    # wall totals, counter totals, the per-round clock-model ledger, and
    # its drift statistics (repro_torch.obs.Tracer.summary)
    telemetry: dict = dataclasses.field(default_factory=dict)

    def as_dict(self) -> dict:
        """JSON-round-trippable dict (``json.dump``-able as-is);
        :class:`repro_torch.core.replan.ReplanEvent` entries of
        ``replans`` are converted through their own ``as_dict``."""
        d = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        d["replans"] = [r.as_dict() if hasattr(r, "as_dict") else r
                        for r in self.replans]
        return d


class Draws:
    """The run's random draws from one CPU ``torch.Generator`` seeded from
    ``seed`` (the same numbers whatever device the run uses).

    A replacement (tests replay the reference's draws) provides the same
    methods; ``t`` is the round index.
    """

    def __init__(self, seed: int = 0):
        self.gen = torch.Generator(device="cpu").manual_seed(int(seed))

    def poisson(self, t: int, lam: torch.Tensor) -> torch.Tensor:
        """Straggler depths z ~ Poisson(lam), shape of ``lam``."""
        return torch.poisson(lam.to("cpu", torch.float32), generator=self.gen)

    def gamma(self, t: int, a: int, n: int) -> torch.Tensor:
        """n draws of Gamma(a, 1) for integer a: sums of a Exp(1)."""
        return torch.empty((n, a)).exponential_(generator=self.gen).sum(1)

    def batch_indices(self, t: int, U: int, s_max: int) -> torch.Tensor:
        """(U, s_max) raw minibatch draws in [0, 2**30)."""
        return torch.randint(0, 2 ** 30, (U, s_max), generator=self.gen)


class DeviceRatio:
    """``count / n`` with ``count`` a 0-d integer tensor on the device:
    ``float()`` reads the count (the one sync) and divides in Python's
    double, so the value is that of a blocking ``float(count) / n``."""

    __slots__ = ("count", "n")

    def __init__(self, count: torch.Tensor, n: int):
        self.count, self.n = count, int(n)

    def __float__(self) -> float:
        return float(self.count) / float(self.n)


@torch.no_grad()
def evaluate(model: ModelAPI, params: PyTree, x: torch.Tensor, y: torch.Tensor,
             batch: int = 512) -> DeviceRatio:
    """Full test-set accuracy, its correct-count kept on the device (no
    host sync); ``float()`` the result for a Python number."""
    n = x.shape[0]
    correct = torch.zeros((), dtype=torch.int64, device=x.device)
    for i in range(0, n, batch):
        logits = model.predict(params, x[i:i + batch])
        correct += (logits.argmax(-1) == y[i:i + batch]).sum()
    return DeviceRatio(correct, n)


@torch.no_grad()
def eval_metrics(model: ModelAPI, params: PyTree, test_x: torch.Tensor,
                 test_y: torch.Tensor, *, loss_samples: int = 256
                 ) -> tuple[DeviceRatio, torch.Tensor]:
    """(accuracy over the full test set, mean loss over a fixed head), both
    still on the device: ``float()`` each for a Python number."""
    acc = evaluate(model, params, test_x, test_y)
    n = min(loss_samples, int(test_y.shape[0]))
    w = torch.full((n,), 1.0 / n, dtype=torch.float32, device=test_x.device)
    return acc, model.loss(params, test_x[:n], test_y[:n], w)


def probe_s_max(policy: Policy, rounds: int, *, view=None) -> int:
    """Largest batch size the policy can plan over the whole horizon
    (against ``view`` when given), so per-client minibatches can be padded
    to one fixed width. A schedule is probed at every round's deadline (a
    re-planned tail need not be monotone); fixed-deadline policies plan
    the same batch every round and are probed at both ends."""
    cfg = view if view is not None else policy.cfg
    sch = getattr(policy, "schedule", None)
    R = max(int(rounds), 1)
    if sch is not None and len(np.asarray(sch.T)) >= R:
        return int(sch.batch_sizes(cfg)[:R].max())
    draws = Draws(0)
    plans = [policy.round(draws, t, view=view)
             for t in (0, max(rounds - 1, 0))]
    return int(max(float(torch.max(pl.batch_sizes)) for pl in plans))


@dataclasses.dataclass
class Cohort:
    """One round's stacked client data: ``x`` (U, n_pad, ...), ``y``
    (U, n_pad), ``counts`` (U,) valid samples per client, on the run's
    device. ``view`` is the AnalysisConfig the policy plans this round
    against (None: its static config), ``available`` the reachable-device
    count (None outside fleet runs), ``regions`` the clients' edge-region
    ids ((U,) int32 from the population draw, read by the hierarchical
    backend; None: its contiguous split)."""

    x: Any
    y: Any
    counts: Any
    view: Any = None
    available: Optional[int] = None
    regions: Optional[np.ndarray] = None

    @property
    def size(self) -> int:
        return int(self.x.shape[0])


class StaticCohortSource:
    """The same pre-stacked client population every round (cohort ==
    population, no churn)."""

    def __init__(self, client_x, client_y, n_per_client, *, device):
        dev = torch.device(device)
        self._cohort = Cohort(x=torch.as_tensor(client_x, device=dev),
                              y=torch.as_tensor(client_y, device=dev),
                              counts=torch.as_tensor(n_per_client, device=dev))

    @property
    def cohort_size(self) -> int:
        return self._cohort.size

    def round_cohort(self, t: int) -> Cohort:
        return self._cohort


@dataclasses.dataclass
class RoundContext:
    """The round's view of the simulated clock and straggler model, for
    backends that read it (``needs_ctx``).

    ``sim_start``/``sim_end`` are the round's simulated-clock span
    (``sim_end - sim_start`` = planned deadline); ``lam`` the Poisson rates
    of the straggler draw; ``layer_s`` the mean per-layer backprop time
    ``S_u / P_u``; ``B`` the comm/setup overhead — all over the active
    (unpadded) cohort rows. ``regions`` holds the clients' edge-region ids
    from the population draw (None: the hierarchical backend splits the
    cohort contiguously); ``available`` the reachable count (fleet runs).
    ``mask`` is the planner's host copy of the padded (U_pad, L)
    contribution mask, so a backend that decides on the host (the buffered
    backend's carry ring) never reads the device's copy back.
    """

    t: int
    sim_start: float
    sim_end: float
    U_act: int
    lam: np.ndarray        # (U_act,)
    layer_s: np.ndarray    # (U_act,)
    B: np.ndarray          # (U_act,)
    regions: Any = None
    available: Optional[int] = None
    mask: Optional[np.ndarray] = None    # (U_pad, L) float32, host


def _round_context(t: int, elapsed: float, plan: RoundPlan, cfg,
                   U_act: int, *, U_pad: Optional[int] = None,
                   regions=None, available=None) -> RoundContext:
    """Recover the straggler-model rates the plan was drawn under: every
    policy prices a client's layer clock as Exp(S_u / P_u) within the
    deadline ``plan.elapsed``, so ``lam = P/S * max(T - B, 0)``. ``cfg`` is
    the view the policy planned against."""
    mask = np.asarray(plan.mask, np.float32)              # host tensor
    mask_h = np.zeros((max(int(U_pad or 0), U_act), mask.shape[1]),
                      np.float32)
    mask_h[:U_act] = mask[:U_act]
    T_d = float(plan.elapsed)
    P = np.asarray(cfg.P, np.float32)[:U_act]
    B = np.asarray(cfg.B_eff, np.float32)[:U_act]
    S = np.asarray(plan.batch_sizes, np.float32)
    S = (np.full(U_act, float(S), np.float32) if S.ndim == 0
         else S[:U_act])
    lam = P / np.maximum(S, 1.0) * np.maximum(T_d - B, 0.0)
    layer_s = S / np.maximum(P, 1e-9)
    return RoundContext(t=t, sim_start=float(elapsed),
                        sim_end=float(elapsed) + T_d, U_act=int(U_act),
                        lam=lam, layer_s=layer_s, B=B, regions=regions,
                        available=available, mask=mask_h)


@dataclasses.dataclass
class _Prepared:
    """One round from the sequential planner: what the dispatch needs, plus
    the planner's span timings to emit on the main thread. ``kind`` is
    ``"round"`` (executable), ``"skip"`` (empty cohort) or ``"stop"`` (the
    T_max check failed); ``replan`` is a re-solve's (event record, solver
    steps). The stacked tensors are one slot of the prefetch double
    buffer, dropped by :meth:`release` once the round's work is queued;
    ``ready`` is the CUDA event recorded after a worker's gathers on its
    side stream."""

    kind: str
    spans: list                        # [(phase, t0, dur_s, attrs)]
    t_start: float = 0.0               # the planner's wall window, for the
    t_end: float = 0.0                 # prefetch_overlap_s counter
    replan: Optional[tuple] = None
    available: Optional[int] = None
    view_cfg: Any = None
    plan: Any = None
    xb: Any = None
    yb: Any = None
    wb: Any = None
    mask: Any = None
    U_act: int = 0
    ctx: Any = None
    h2d_bytes: int = 0
    ready: Any = None

    def stacked(self) -> tuple:
        return self.xb, self.yb, self.wb, self.mask

    def release(self) -> None:
        self.xb = self.yb = self.wb = self.mask = None


class RoundRuntime:
    """The federated round loop, parameterized by execution backend.

    HOW rounds execute is an :class:`repro_torch.fl.spec.ExecSpec`
    (``exec=``): backend selection, its knobs (``chunk_size``,
    ``regions``, ``mesh``), the local update's ``local_iters`` / ``l2``,
    the client->server wire format, and the round loop's ``pipeline``
    (``serial`` or ``prefetch``). The individual kwargs remain as aliases —
    both forms funnel through :meth:`ExecSpec.resolve`, so trajectories are
    bit-identical either way. ``backend`` may also be an
    :class:`repro_torch.fl.backends.ExecutionBackend` instance (passed
    through). ``device`` is where params, data and the round's compute live
    (the card unless the caller passes another). ``tracer``
    (:class:`repro_torch.obs.Tracer`) enables telemetry for the runtime AND
    the backend; the default records nothing and perturbs nothing.
    """

    def __init__(self, model: ModelAPI, policy: Policy, *,
                 exec: Optional[ExecSpec] = None, backend=None,
                 chunk_size: Optional[int] = None,
                 local_iters: Optional[int] = None,
                 l2: Optional[float] = None, donate: Optional[bool] = None,
                 compression=None, agg_impl: Optional[str] = None,
                 tracer=None, device=None):
        self.model = model
        self.policy = policy
        self.device = resolve_device(device)
        self.tracer = tracer if tracer is not None else obs.NULL_TRACER
        self.backend = make_backend(backend, model, exec=exec,
                                    chunk_size=chunk_size,
                                    local_iters=local_iters, l2=l2,
                                    donate=donate, compression=compression,
                                    agg_impl=agg_impl, device=self.device)
        self.backend.set_tracer(self.tracer)
        self.pipeline = exec.pipeline if exec is not None else "serial"
        self._wmask_cache: dict[bytes, PyTree] = {}

    # ------------------------------------------------------------------
    def _width_masks(self, params: PyTree, ratios, U_pad: int) -> PyTree:
        r = np.asarray(ratios, np.float32)
        if r.shape[0] < U_pad:
            # padded clients pose as full-width; their mask row is zero, so
            # they never touch the overlap mean
            r = np.concatenate([r, np.ones(U_pad - r.shape[0], np.float32)])
        key = r.tobytes()
        if key not in self._wmask_cache:
            # bound the cache (each entry is a cohort-sized mask pytree)
            while len(self._wmask_cache) >= 8:
                self._wmask_cache.pop(next(iter(self._wmask_cache)))
            self._wmask_cache[key] = self.model.width_masks(params, r)
        return self._wmask_cache[key]

    def _prepare(self, cohort: Cohort, plan: RoundPlan, idx, s_max: int,
                 U_pad: int):
        """Sample the per-client minibatches from the raw draws ``idx``
        (drawn at the UNPADDED cohort width, so every backend gets the same
        minibatches), then pad the cohort axis to the backend's width with
        all-zero batches, weights and mask rows: their aggregation
        coefficients are 0, so they contribute nothing."""
        U_act = cohort.size
        xb, yb, wb = sample_client_batches(idx, cohort.x, cohort.y,
                                           cohort.counts, plan.batch_sizes,
                                           s_max)
        mask = plan.mask.to(device=xb.device, dtype=torch.float32)
        if U_pad != U_act:
            def zrow(a):
                return torch.cat([a, a.new_zeros((U_pad - U_act,)
                                                 + tuple(a.shape[1:]))])
            xb, yb, wb, mask = zrow(xb), zrow(yb), zrow(wb), zrow(mask)
        return xb, yb, wb, mask, U_act

    # ------------------------------------------------------------------
    def run(self, source, *, rounds: int, T_max: float, eta, s_max: int,
            test_x=None, test_y=None, seed: int = 0, eval_every: int = 1,
            on_round: Optional[Callable] = None,
            init_params: PyTree | None = None,
            draws=None, replan=None, method: str = "",
            eval_fn: Optional[Callable] = None,
            verbose: bool = False) -> tuple[PyTree, History]:
        """Run up to ``rounds`` rounds, stopping before the round whose
        deadline would take the simulated clock past ``T_max``; returns
        ``(params, History)``. The eval metrics are recorded every
        ``eval_every`` rounds and after the last, as Python floats by the
        time ``run`` returns: ``eval_fn(params) -> (metric, loss)`` when
        given (the task's eval, e.g. token accuracy and token CE for an LM:
        :meth:`repro_torch.fl.tasks.Task.eval_fn`), else accuracy and loss
        (:func:`eval_metrics`) on ``test_x``/``test_y``.

        ``on_round(t, params, hist)`` runs after every executed round, with
        ``hist`` converted so far. ``draws`` (default ``Draws(seed)``)
        supplies every random draw; ``init_params`` (default ``model.init``
        from the draws' generator) the starting params.

        ``replan`` (None | trigger name | :class:`repro_torch.core.replan.
        ReplanConfig`) enables online re-solving of the remaining-horizon
        Problem 2: the trigger is evaluated before each round against the
        source's reachable count, the re-solve warm-starts from the
        incumbent schedule's tail, and each event is appended to
        ``History.replans``. A round whose cohort is empty (``round_cohort``
        returns None) never starts; its planned deadline is credited back
        to the replanner (:meth:`repro_torch.core.replan.Replanner.
        note_skip`), which forces a re-solve at the next executed round.
        Sources may expose ``replan_view(t, budget_left, eta_tail)`` to
        re-estimate the population view (the fleet source does) and
        ``plan_rate_max`` to bound the re-solved batches. ``method`` names
        the run in ``History``; ``verbose`` prints each eval and replan.
        """
        model, policy, backend, dev = (self.model, self.policy, self.backend,
                                       self.device)
        if policy.name == "heterofl" and model.width_masks is None:
            raise ValueError("model does not support HeteroFL width masks")
        replan = make_replan(replan)
        replanner = (Replanner(replan, policy, rounds, eta, s_max=s_max,
                               rate_max=getattr(source, "plan_rate_max",
                                                None), device=dev)
                     if replan is not None and replan.active else None)
        if eval_fn is None:
            if test_x is None or test_y is None:
                raise ValueError("run() needs either eval_fn or "
                                 "test_x/test_y")
            tx = torch.as_tensor(test_x, device=dev)
            ty = torch.as_tensor(test_y, device=dev)

            def eval_fn(p):
                return eval_metrics(model, p, tx, ty)
        draws = Draws(seed) if draws is None else draws
        params = (model.init(draws.gen, dev) if init_params is None else
                  init_params)
        eta = np.asarray(eta, np.float32)
        U_pad = backend.cohort_pad(source.cohort_size)
        backend.reset_state()
        needs_ctx = bool(getattr(backend, "needs_ctx", False))
        prefetch = self.pipeline == "prefetch"

        tracer = self.tracer
        hist = History(method=method or policy.name)
        elapsed = 0.0
        wall_start = obs.now()

        # -- the sequential planner ---------------------------------------
        # It reads host state only (the cohort source, the replanner, the
        # policy, the draws, the PLANNED clock: plan.elapsed is known before
        # the round runs), never a result of a round, so prefetch can run
        # it one round ahead and the trajectory stays bit-identical. Its
        # clock mirrors `elapsed`: every planned round is executed, skips
        # spend nothing, and a "stop" halts both.
        planned_elapsed = 0.0

        def plan_round(t: int) -> _Prepared:
            nonlocal planned_elapsed
            spans: list = []
            t_start = t0 = obs.now()
            cohort = source.round_cohort(t)
            spans.append(("cohort", t0, obs.now() - t0, {}))
            if cohort is None:
                # nobody reachable: the round never starts and spends
                # nothing; its planned deadline is credited back
                if replanner is not None:
                    replanner.note_skip(t)
                return _Prepared(kind="skip", spans=spans, t_start=t_start,
                                 t_end=obs.now())
            rep = None
            if replanner is not None:
                reachable = (cohort.available if cohort.available is not None
                             else source.cohort_size)
                if replanner.should_replan(t, reachable):
                    view = None
                    budget_left = max(T_max - planned_elapsed, 1e-6)
                    view_fn = getattr(source, "replan_view", None)
                    if view_fn is not None:
                        view = view_fn(t, budget_left, eta[t:rounds])
                    t0 = obs.now()
                    ev = replanner.replan(t, budget_left, reachable, view)
                    spans.append(("replan", t0, obs.now() - t0,
                                  {"reachable": int(reachable)}))
                    rep = (ev.as_dict(), int(ev.steps))
            t0 = obs.now()
            plan = policy.round(draws, t, view=cohort.view)
            spans.append(("plan", t0, obs.now() - t0, {}))
            if planned_elapsed + plan.elapsed > T_max * (1 + 1e-6):
                return _Prepared(kind="stop", spans=spans, replan=rep,
                                 t_start=t_start, t_end=obs.now())
            t0 = obs.now()
            xb, yb, wb, mask, U_act = self._prepare(
                cohort, plan, draws.batch_indices(t, cohort.size, s_max),
                s_max, U_pad)
            spans.append(("stack", t0, obs.now() - t0, {}))
            view_cfg = cohort.view if cohort.view is not None else policy.cfg
            ctx = (_round_context(t, planned_elapsed, plan, view_cfg, U_act,
                                  U_pad=U_pad, regions=cohort.regions,
                                  available=cohort.available)
                   if needs_ctx else None)
            planned_elapsed += plan.elapsed
            return _Prepared(kind="round", spans=spans, t_start=t_start,
                             t_end=obs.now(), replan=rep,
                             available=cohort.available, view_cfg=view_cfg,
                             plan=plan, xb=xb, yb=yb, wb=wb, mask=mask,
                             U_act=U_act, ctx=ctx,
                             h2d_bytes=obs.tree_bytes((xb, yb, wb, mask)))

        side = (torch.cuda.Stream(device=dev)
                if prefetch and dev.type == "cuda" else None)

        def plan_ahead(t: int) -> _Prepared:
            """The worker's call: on a CUDA device the planner's gathers go
            on the side stream, with an event recorded after them."""
            if side is None:
                return plan_round(t)
            with torch.cuda.stream(side):
                prep = plan_round(t)
                prep.ready = torch.cuda.Event()
                prep.ready.record(side)
            return prep

        def hand_over(prep: _Prepared) -> None:
            """Order the main stream after the worker's gathers, and mark
            their tensors as used by it: the caching allocator then keeps
            their memory until the main stream's work on them is done."""
            if prep.ready is None:
                return
            main = torch.cuda.current_stream(dev)
            main.wait_event(prep.ready)
            for a in prep.stacked():
                a.record_stream(main)

        pool = (concurrent.futures.ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="prefetch")
                if prefetch else None)
        pending: Optional[concurrent.futures.Future] = None
        pending_evals: list[int] = []    # History rows awaiting float()
        warmed = False
        dispatch_t0: Optional[float] = None

        def drain_evals() -> None:
            """Convert the deferred eval device scalars in History (the
            conversion is the sync point)."""
            for i in pending_evals:
                hist.accuracy[i] = float(hist.accuracy[i])
                hist.train_loss[i] = float(hist.train_loss[i])
            pending_evals.clear()

        try:
            for t in range(rounds):
                tracer.set_round(t + 1)
                wall_round0 = obs.now() if tracer.active else 0.0
                if pending is not None:
                    t0 = obs.now()
                    prep: _Prepared = pending.result()
                    pending = None
                    if tracer.active:
                        t_res = obs.now()
                        tracer.count("dispatch_wait_s", round(t_res - t0, 6))
                        tracer.count("prefetch_rounds", 1)
                        if dispatch_t0 is not None:
                            # worker wall time hidden behind the previous
                            # round's dispatch window
                            lo = max(prep.t_start, dispatch_t0)
                            hi = min(prep.t_end, t_res)
                            if hi > lo:
                                tracer.count("prefetch_overlap_s",
                                             round(hi - lo, 6))
                else:
                    prep = plan_round(t)
                for name, s0, dur, attrs in prep.spans:
                    tracer.span_record(name, s0, dur, **attrs)
                if prep.replan is not None:
                    rec, steps = prep.replan
                    hist.replans.append(rec)
                    tracer.event("replan", **rec)
                    tracer.count("replan_solver_steps", steps)
                    drain_evals()        # replan events report live state
                    if verbose:
                        print(obs.format_replan(hist.method, rec))
                if prep.kind == "skip":
                    # the next round is planned inline: nothing is pending
                    tracer.count("rounds_skipped", 1)
                    continue
                if prep.kind == "stop":
                    break
                hand_over(prep)
                plan, U_act = prep.plan, prep.U_act
                wmasks = None
                if plan.width_ratios is not None:
                    # HeteroFL masks read the LIVE params: the one input
                    # the planner cannot speculate on
                    t0 = obs.now()
                    wmasks = self._width_masks(params, plan.width_ratios,
                                               U_pad)
                    tracer.span_record("stack", t0, obs.now() - t0,
                                       part="wmasks")
                if prefetch and prep.replan is None and t + 1 < rounds:
                    # plan round t+1 while round t runs; a replan round
                    # forces the next plan inline
                    pending = pool.submit(plan_ahead, t + 1)
                if prefetch and not warmed:
                    # one round and one eval on zero params before round 0
                    # dispatches, so its one-off costs stay out of it
                    t0 = obs.now()
                    backend.warm_up(params, *prep.stacked(), plan.p,
                                    float(eta[t]),
                                    bias_correct=bool(plan.bias_correct),
                                    wmasks=wmasks, ctx=prep.ctx)
                    eval_fn(tree_map(torch.zeros_like, params))
                    sync(dev)
                    dur = obs.now() - t0
                    tracer.span_record("warm_up", t0, dur)
                    tracer.count("warm_up_s", round(dur, 6))
                    warmed = True
                available = prep.available
                dispatch_t0 = obs.now()
                params = backend.run_round(params, *prep.stacked(), plan.p,
                                           float(eta[t]),
                                           bias_correct=bool(
                                               plan.bias_correct),
                                           wmasks=wmasks, ctx=prep.ctx)
                tracer.count("h2d_bytes", prep.h2d_bytes)
                prep.release()       # free this round's double-buffer slot
                elapsed += plan.elapsed
                if tracer.active:
                    # the clock-model ledger row: planned deadline vs
                    # simulated clock vs measured wall vs the model's view
                    sync(dev)
                    wall_now = obs.now()
                    tracer.count(
                        "batch_elements_real",
                        int(np.minimum(np.asarray(plan.batch_sizes,
                                                  np.float64)[:U_act],
                                       float(s_max)).sum()))
                    tracer.count("batch_elements_padded", U_pad * s_max)
                    tracer.gauge("cohort_size", U_act)
                    tracer.event("round", **obs.round_record(
                        t=t, plan=plan, cfg=prep.view_cfg, L=model.L,
                        U_act=U_act, U_pad=U_pad, s_max=s_max,
                        sim_total=elapsed,
                        wall_round_s=wall_now - wall_round0,
                        wall_total_s=wall_now - wall_start,
                        available=available,
                        carry=getattr(backend, "last_carry", None) or None,
                        regions=getattr(backend, "last_regions",
                                        None) or None))
                if (t % eval_every == 0) or (t == rounds - 1):
                    with tracer.span("eval"):
                        acc, loss = eval_fn(params)
                        if tracer.active:
                            sync(dev)
                    hist.times.append(elapsed)
                    hist.rounds.append(t + 1)
                    hist.accuracy.append(acc)
                    hist.deadlines.append(float(plan.elapsed))
                    hist.train_loss.append(loss)
                    if available is not None:
                        hist.available.append(int(available))
                    pending_evals.append(len(hist.accuracy) - 1)
                    if tracer.active or verbose:
                        # the record is rendered from what History keeps:
                        # only this report boundary pays the conversion
                        drain_evals()
                        rec = {"round": t + 1, "available": available,
                               "cohort": U_act, "sim_total": elapsed,
                               "T_deadline": float(plan.elapsed),
                               "acc": hist.accuracy[-1],
                               "loss": hist.train_loss[-1]}
                        tracer.event("eval", **rec)
                        if verbose:
                            print(obs.format_eval(hist.method, rec))
                if on_round is not None:
                    drain_evals()    # hooks read converted History
                    on_round(t, params, hist)
        finally:
            if pool is not None:
                if pending is not None:
                    pending.cancel()
                pool.shutdown(wait=True)
        drain_evals()
        tracer.set_round(None)
        if tracer.active:
            hist.telemetry = tracer.summary()
        return params, hist
