"""Static-population front-end over the round runtime, in PyTorch (port of
``repro.fl.server``).

``run_federated`` probes ``s_max``, wraps the pre-stacked client arrays in
a :class:`repro_torch.fl.runtime.StaticCohortSource` and hands the loop to
:class:`repro_torch.fl.runtime.RoundRuntime`. HOW each round executes is
an :class:`repro_torch.fl.spec.ExecSpec` (``exec=``) selecting one of the
:mod:`repro_torch.fl.backends` backends — ``dense`` (the default),
``chunked``, ``shard_map``, ``temporal``, ``buffered`` or
``hierarchical`` — numerically equivalent up to float summation order
(``buffered`` with ``lam=0``; with ``lam>0`` it folds late work into
later rounds), under the ``serial`` or ``prefetch`` round loop
(bit-identical).
"""
from __future__ import annotations

from repro_torch.core.baselines import Policy
from repro_torch.core.types import AnalysisConfig
from repro_torch.device import resolve_device
from repro_torch.fl.runtime import (History, ModelAPI, RoundRuntime,
                                    StaticCohortSource, probe_s_max)
from repro_torch.fl.spec import ExecSpec

__all__ = ["run_federated"]

PyTree = object


def run_federated(model: ModelAPI, policy: Policy, cfg: AnalysisConfig,
                  client_x, client_y, n_per_client, test_x, test_y, *,
                  seed: int = 0, exec: ExecSpec | None = None,
                  local_iters: int | None = None, l2: float | None = None,
                  eval_every: int = 1, backend=None,
                  chunk_size: int | None = None, donate: bool | None = None,
                  compression=None, agg_impl: str | None = None,
                  on_round=None, tracer=None,
                  init_params: PyTree | None = None, draws=None,
                  replan=None, verbose: bool = False,
                  device=None) -> tuple[PyTree, History]:
    """Run up to R rounds at learning rates ``cfg.eta``, stopping when the
    simulated clock would exceed T_max. Client arrays are numpy arrays or
    tensors, moved to ``device`` (the card unless the caller passes
    another).

    HOW rounds execute is one :class:`repro_torch.fl.spec.ExecSpec`
    (``exec=``): the backend (dense by default), ``chunk_size`` /
    ``regions``, ``local_iters`` / ``l2``, and ``compression`` (None,
    ``"int8"``, ``"topk8"`` or ``("topk8", frac)``). The individual kwargs
    are aliases kept for compatibility; both forms resolve through
    :meth:`ExecSpec.resolve` and give bit-identical trajectories.
    ``tracer`` (:class:`repro_torch.obs.Tracer`) records phase spans,
    counters and the clock-model ledger into ``History.telemetry``.
    ``replan`` (None | trigger name | :class:`repro_torch.core.replan.
    ReplanConfig`) re-solves the remaining horizon mid-run (ADEL only).
    ``seed``, ``on_round``, ``draws``, ``init_params`` and ``verbose``
    (print each eval and replan) are those of :meth:`RoundRuntime.run`."""
    dev = resolve_device(device)
    # largest batch any client can be assigned under the policy
    s_max = max(min(probe_s_max(policy, cfg.R), int(client_y.shape[1])), 2)
    runtime = RoundRuntime(model, policy, exec=exec, backend=backend,
                           chunk_size=chunk_size, local_iters=local_iters,
                           l2=l2, donate=donate, compression=compression,
                           agg_impl=agg_impl, tracer=tracer, device=dev)
    source = StaticCohortSource(client_x, client_y, n_per_client, device=dev)
    return runtime.run(source, rounds=cfg.R, T_max=cfg.T_max, eta=cfg.eta,
                       s_max=s_max, test_x=test_x, test_y=test_y, seed=seed,
                       eval_every=eval_every, on_round=on_round,
                       init_params=init_params, draws=draws,
                       replan=replan, verbose=verbose)
