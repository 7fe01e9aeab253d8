"""The federated round loop, in PyTorch (port of the serial path of
``repro.fl.runtime``).

:class:`RoundRuntime` owns per-round policy planning, minibatch sampling,
cohort padding to the backend's width (padded rows carry an all-zero mask,
batch weights and data, so they contribute nothing), HeteroFL width-mask
derivation (cached per distinct width-ratio vector), the simulated
wall-clock under Requirements R1 (at most R rounds) and R2 (total
simulated time <= T_max), eval cadence and the :class:`History` record.
HOW a round executes is an :class:`repro_torch.fl.backends.
ExecutionBackend` (``dense`` / ``chunked`` / ``temporal`` /
``hierarchical``), selected through one :class:`repro_torch.fl.spec.
ExecSpec`.

Every random draw of a run comes from one :class:`Draws` object: the
initial params, each round's Poisson depths (and the Wait baseline's Gamma
clocks) and each round's minibatch indices, drawn at the unpadded cohort
width so every backend sees the same minibatches. By default it is a
``torch.Generator`` seeded from ``seed``. The reference's JAX draws cannot
be reproduced by a torch generator, so tests pass a draw source of their
own that replays the reference's key sequence, plus ``init_params``.

Observability flows through the single ``tracer=`` hook
(:mod:`repro_torch.obs`, default :data:`repro_torch.obs.NULL_TRACER` —
bit-identical trajectories): the runtime emits the ``cohort`` / ``plan`` /
``stack`` / ``eval`` spans (the backends add ``local_train`` /
``aggregate``), the ``batch_elements_real`` / ``batch_elements_padded`` /
``h2d_bytes`` counters and the ``cohort_size`` gauge, and one clock-model
ledger event per executed round (:func:`repro_torch.obs.ledger.
round_record`); the summary lands in ``History.telemetry``. On a CUDA
device an active tracer synchronizes at the end of the backend's spans,
of each round and of each eval, where the reference blocks on its
results.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.baselines import Policy, RoundPlan
from repro_torch.device import resolve_device, sync
from repro_torch.fl.backends import make_backend
from repro_torch.fl.client import sample_client_batches
from repro_torch.fl.spec import ExecSpec

PyTree = Any

__all__ = ["ModelAPI", "History", "Cohort", "StaticCohortSource",
           "RoundContext", "Draws", "RoundRuntime", "probe_s_max",
           "evaluate", "eval_metrics"]


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
    method: str = ""
    # tracer-enabled runs only: the run's telemetry summary — per-phase
    # wall totals, counter totals, the per-round clock-model ledger, and
    # its drift statistics (repro_torch.obs.Tracer.summary)
    telemetry: dict = dataclasses.field(default_factory=dict)

    def as_dict(self) -> dict:
        """JSON-round-trippable dict (``json.dump``-able as-is)."""
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}


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


@torch.no_grad()
def evaluate(model: ModelAPI, params: PyTree, x: torch.Tensor, y: torch.Tensor,
             batch: int = 512) -> float:
    """Full test-set accuracy."""
    n = x.shape[0]
    correct = torch.zeros((), dtype=torch.int64, device=x.device)
    for i in range(0, n, batch):
        logits = model.predict(params, x[i:i + batch])
        correct += (logits.argmax(-1) == y[i:i + batch]).sum()
    return float(correct) / float(n)


@torch.no_grad()
def eval_metrics(model: ModelAPI, params: PyTree, test_x: torch.Tensor,
                 test_y: torch.Tensor, *, loss_samples: int = 256
                 ) -> tuple[float, float]:
    """(accuracy over the full test set, mean loss over a fixed head)."""
    acc = evaluate(model, params, test_x, test_y)
    n = min(loss_samples, int(test_y.shape[0]))
    w = torch.full((n,), 1.0 / n, dtype=torch.float32, device=test_x.device)
    return acc, float(model.loss(params, test_x[:n], test_y[:n], w))


def probe_s_max(policy: Policy, rounds: int) -> int:
    """Largest batch size the policy can plan over the whole horizon, so
    per-client minibatches can be padded to one fixed width."""
    sch = getattr(policy, "schedule", None)
    R = max(int(rounds), 1)
    if sch is not None and len(np.asarray(sch.T)) >= R:
        return int(sch.batch_sizes(policy.cfg)[:R].max())
    draws = Draws(0)
    plans = [policy.round(draws, t) for t in (0, max(rounds - 1, 0))]
    return int(max(float(torch.max(pl.batch_sizes)) for pl in plans))


@dataclasses.dataclass
class Cohort:
    """One round's stacked client data: ``x`` (U, n_pad, ...), ``y``
    (U, n_pad), ``counts`` (U,) valid samples per client."""

    x: Any
    y: Any
    counts: Any

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
    (None until fleets are ported: the hierarchical backend then splits the
    cohort contiguously).
    """

    t: int
    sim_start: float
    sim_end: float
    U_act: int
    lam: np.ndarray        # (U_act,)
    layer_s: np.ndarray    # (U_act,)
    B: np.ndarray          # (U_act,)
    regions: Any = None


def _round_context(t: int, elapsed: float, plan: RoundPlan, cfg,
                   U_act: int) -> RoundContext:
    """Recover the straggler-model rates the plan was drawn under: every
    policy prices a client's layer clock as Exp(S_u / P_u) within the
    deadline ``plan.elapsed``, so ``lam = P/S * max(T - B, 0)``."""
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
                        lam=lam, layer_s=layer_s, B=B)


class RoundRuntime:
    """The serial federated round loop, parameterized by execution backend.

    HOW rounds execute is an :class:`repro_torch.fl.spec.ExecSpec`
    (``exec=``): backend selection, its knobs (``chunk_size``,
    ``regions``), the local update's ``local_iters`` / ``l2``, and the
    client->server wire format. The individual kwargs remain as aliases —
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
            test_x, test_y, seed: int = 0, eval_every: int = 1,
            on_round: Optional[Callable] = None,
            init_params: PyTree | None = None,
            draws=None) -> tuple[PyTree, History]:
        """Run up to ``rounds`` rounds, stopping before the round whose
        deadline would take the simulated clock past ``T_max``; returns
        ``(params, History)``. Accuracy and loss (:func:`eval_metrics` on
        ``test_x``/``test_y``) are recorded every ``eval_every`` rounds and
        after the last.

        ``on_round(t, params, hist)`` runs after every executed round.
        ``draws`` (default ``Draws(seed)``) supplies every random draw;
        ``init_params`` (default ``model.init`` from the draws' generator)
        the starting params.
        """
        model, policy, backend, dev = (self.model, self.policy, self.backend,
                                       self.device)
        if policy.name == "heterofl" and model.width_masks is None:
            raise ValueError("model does not support HeteroFL width masks")
        tx = torch.as_tensor(test_x, device=dev)
        ty = torch.as_tensor(test_y, device=dev)
        draws = Draws(seed) if draws is None else draws
        params = (model.init(draws.gen, dev) if init_params is None else
                  init_params)
        eta = np.asarray(eta, np.float32)
        U_pad = backend.cohort_pad(source.cohort_size)
        backend.reset_state()
        needs_ctx = bool(getattr(backend, "needs_ctx", False))

        tracer = self.tracer
        hist = History(method=policy.name)
        elapsed = 0.0
        wall_start = obs.now()
        for t in range(rounds):
            tracer.set_round(t + 1)
            wall_round0 = obs.now() if tracer.active else 0.0
            with tracer.span("cohort"):
                cohort = source.round_cohort(t)
            with tracer.span("plan"):
                plan = policy.round(draws, t)
            if elapsed + plan.elapsed > T_max * (1 + 1e-6):
                break
            with tracer.span("stack"):
                xb, yb, wb, mask, U_act = self._prepare(
                    cohort, plan, draws.batch_indices(t, cohort.size, s_max),
                    s_max, U_pad)
            wmasks = None
            if plan.width_ratios is not None:
                t0 = obs.now()
                wmasks = self._width_masks(params, plan.width_ratios, U_pad)
                tracer.span_record("stack", t0, obs.now() - t0,
                                   part="wmasks")
            ctx = (_round_context(t, elapsed, plan, policy.cfg, U_act)
                   if needs_ctx else None)
            params = backend.run_round(params, xb, yb, wb, mask, plan.p,
                                       float(eta[t]),
                                       bias_correct=bool(plan.bias_correct),
                                       wmasks=wmasks, ctx=ctx)
            elapsed += plan.elapsed
            if tracer.active:
                # the clock-model ledger row: planned deadline vs simulated
                # clock vs measured wall vs the model's view
                tracer.count("h2d_bytes", obs.tree_bytes((xb, yb, wb, mask)))
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
                    t=t, plan=plan, cfg=policy.cfg, L=model.L, U_act=U_act,
                    U_pad=U_pad, s_max=s_max, sim_total=elapsed,
                    wall_round_s=wall_now - wall_round0,
                    wall_total_s=wall_now - wall_start,
                    regions=getattr(backend, "last_regions", None) or None))
            if (t % eval_every == 0) or (t == rounds - 1):
                with tracer.span("eval"):
                    acc, loss = eval_metrics(model, params, tx, ty)
                hist.times.append(elapsed)
                hist.rounds.append(t + 1)
                hist.accuracy.append(acc)
                hist.deadlines.append(float(plan.elapsed))
                hist.train_loss.append(loss)
                if tracer.active:
                    tracer.event("eval", round=t + 1, available=None,
                                 cohort=U_act, sim_total=elapsed,
                                 T_deadline=float(plan.elapsed), acc=acc,
                                 loss=loss)
            if on_round is not None:
                on_round(t, params, hist)
        tracer.set_round(None)
        if tracer.active:
            hist.telemetry = tracer.summary()
        return params, hist
