"""The federated round loop, in PyTorch (port of the serial path of
``repro.fl.runtime``).

:class:`RoundRuntime` owns per-round policy planning, minibatch sampling, the
simulated wall-clock under Requirements R1 (at most R rounds) and R2 (total
simulated time <= T_max), eval cadence and the :class:`History` record; an
:class:`repro_torch.fl.backends.ExecutionBackend` executes each round.

Every random draw of a run comes from one :class:`Draws` object: the
initial params, each round's Poisson depths (and the Wait baseline's Gamma
clocks) and each round's minibatch indices. By default it is a
``torch.Generator`` seeded from ``seed``. The reference's JAX draws cannot
be reproduced by a torch generator, so tests pass a draw source of their
own that replays the reference's key sequence, plus ``init_params``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core.baselines import Policy
from repro_torch.device import resolve_device
from repro_torch.fl.backends import DenseBackend
from repro_torch.fl.client import sample_client_batches

PyTree = Any

__all__ = ["ModelAPI", "History", "Cohort", "StaticCohortSource", "Draws",
           "RoundRuntime", "probe_s_max", "evaluate", "eval_metrics"]


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


@dataclasses.dataclass
class History:
    times: list = dataclasses.field(default_factory=list)
    rounds: list = dataclasses.field(default_factory=list)
    accuracy: list = dataclasses.field(default_factory=list)
    deadlines: list = dataclasses.field(default_factory=list)
    train_loss: list = dataclasses.field(default_factory=list)
    method: str = ""


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


class RoundRuntime:
    """The serial federated round loop over the dense backend. ``device``
    is where params, data and the round's compute live (the card unless the
    caller passes another).
    """

    def __init__(self, model: ModelAPI, policy: Policy, *,
                 local_iters: int = 1, l2: float = 0.0, compression=None,
                 device=None):
        self.model = model
        self.policy = policy
        self.device = resolve_device(device)
        self.backend = DenseBackend(model, local_iters=local_iters, l2=l2,
                                    compression=compression,
                                    device=self.device)

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
        tx = torch.as_tensor(test_x, device=dev)
        ty = torch.as_tensor(test_y, device=dev)
        draws = Draws(seed) if draws is None else draws
        params = (model.init(draws.gen, dev) if init_params is None else
                  init_params)
        eta = np.asarray(eta, np.float32)

        hist = History(method=policy.name)
        elapsed = 0.0
        for t in range(rounds):
            cohort = source.round_cohort(t)
            plan = policy.round(draws, t)
            if elapsed + plan.elapsed > T_max * (1 + 1e-6):
                break
            xb, yb, wb = sample_client_batches(
                draws.batch_indices(t, cohort.size, s_max), cohort.x,
                cohort.y, cohort.counts, plan.batch_sizes, s_max)
            params = backend.run_round(params, xb, yb, wb, plan.mask, plan.p,
                                       float(eta[t]),
                                       bias_correct=bool(plan.bias_correct))
            elapsed += plan.elapsed
            if (t % eval_every == 0) or (t == rounds - 1):
                acc, loss = eval_metrics(model, params, tx, ty)
                hist.times.append(elapsed)
                hist.rounds.append(t + 1)
                hist.accuracy.append(acc)
                hist.deadlines.append(float(plan.elapsed))
                hist.train_loss.append(loss)
            if on_round is not None:
                on_round(t, params, hist)
        return params, hist
