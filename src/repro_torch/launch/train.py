"""Federated LM training (ADEL-FL on an LM arch) on the card (port
of ``repro.launch.train``).

A thin front end over the round runtime: the arch config becomes a
:func:`repro_torch.fl.tasks.lm_task` (transformer ``ModelAPI`` + synthetic
token streams + token-loss eval), and the round loop is
:class:`repro_torch.fl.runtime.RoundRuntime`, the same loop that runs the
image and fleet workloads. So the paper's pipeline (Problem-2 schedule ->
per-round straggler draws -> deadline-truncated layer-wise aggregation,
Eq. 5 -> SGD) with online re-planning, every execution backend (``dense``,
``chunked``, ``shard_map``, ``temporal``: the grad-accumulation layout of
the big archs, ``buffered``, ``hierarchical``), compression and HeteroFL
runs on LM configs with no LM-specific loop code. The execution surface is
one :class:`repro_torch.fl.spec.ExecSpec` (``exec=`` or the shared
``--backend/--compression/--lam/...`` CLI group); checkpointing rides the
runtime's ``on_round`` hook. Every client's loss runs the hand-written
flash attention and SSD scan kernels forward (plain backwards), and every
fold the grouped fold kernels.

It runs on the card unless ``--device cpu`` is given; ``--reduced`` (the
default) is the 2-block smoke config, ``--full`` the arch at its published
width and depth, ``--layers N`` the arch cut to its first N blocks (a model
too deep for one card at full width):

    python -m repro_torch.launch.train --arch hymba-1.5b --full \\
        --backend temporal --clients 4 --seq 256 --s-max-cap 8 --rounds 3
    python -m repro_torch.launch.train --arch deepseek-v2-lite-16b --full \\
        --layers 2 --backend temporal --clients 4 --seq 256 --s-max-cap 8
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-4b \\
        --device cpu --rounds 6 --tmax 30 --clients 4 --seq 32 --eta0 1.0
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math

import torch

from repro_torch import obs
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_config
from repro_torch.core.baselines import make_policy
from repro_torch.core.replan import TRIGGERS, ReplanConfig
from repro_torch.core.scheduler import solve
from repro_torch.core.types import AnalysisConfig
from repro_torch.device import resolve_device
from repro_torch.fl.runtime import History, RoundRuntime, probe_s_max
from repro_torch.fl.spec import ExecSpec
from repro_torch.fl.tasks import (lm_eval_metrics, lm_fleet_data, lm_task,
                                  make_lm_model)
from repro_torch.fleet.population import PopulationSpec
from repro_torch.tree import tree_leaves

__all__ = ["run_training", "main"]


def run_training(arch: str, *, method: str = "adel", rounds: int = 40,
                 tmax: float = 160.0, U: int = 8, seq: int = 64,
                 n_seq: int = 96, eta0: float = 0.5, seed: int = 0,
                 reduced: bool = True, layers: int | None = None,
                 solver: str = "adam",
                 solver_steps: int | None = None,
                 exec: ExecSpec | None = None,
                 backend: str | None = None, chunk_size: int | None = None,
                 mesh=None, replan=None, local_iters: int | None = None,
                 donate: bool | None = None,
                 compression=None, agg_impl: str | None = None,
                 population=None,
                 s_max_cap: int = 32, eval_every: int | None = None,
                 ckpt: str | None = None, ckpt_every: int | None = None,
                 verbose: bool = True, tracer=None, device=None,
                 draws=None, init_params=None) -> tuple[object, History]:
    """Federated LM training on ``RoundRuntime`` on ``device`` (the card
    unless the caller passes another); returns ``(params, History)``.
    ``History.accuracy`` is next-token accuracy and ``History.train_loss``
    the token CE over a fixed in-pool eval head (perplexity = exp; see
    :func:`repro_torch.fl.tasks.lm_task` for why).

    HOW rounds execute is one :class:`repro_torch.fl.spec.ExecSpec`
    (``exec=``); the individual kwargs are aliases resolved through
    :meth:`ExecSpec.resolve`. The spec's ``compression`` is priced into the
    Problem-2 plan before solving. ``replan`` selects the online
    re-planning trigger (None | "never" | "every-k" | "drift" |
    :class:`repro_torch.core.replan.ReplanConfig`), ``ckpt`` a checkpoint
    path saved every ``ckpt_every`` rounds (default R/4) through the
    ``on_round`` hook, ``tracer`` a :class:`repro_torch.obs.Tracer`.
    ``s_max_cap`` caps the minibatch pad width (sequences a client a
    round). ``layers`` cuts the config to its first ``layers`` blocks.

    ``population`` (None by default) switches WHO the LM trains against: a
    :class:`repro_torch.fleet.population.PopulationSpec`, source string or
    ``Population`` routes the run through
    :func:`repro_torch.fleet.engine.run_fleet` (availability and cohort
    sampling over a simulated device fleet) instead of the static
    ``U``-client pool; the cohort size stays ``U`` and ``ckpt`` is not
    supported there. ``draws`` and ``init_params`` are the draw seam of
    :meth:`RoundRuntime.run` (tests replay the reference's draws).
    """
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if layers is not None:
        cfg = dataclasses.replace(cfg, L=layers)
    dev = resolve_device(device)
    spec = ExecSpec.resolve(exec, backend=backend, chunk_size=chunk_size,
                            mesh=mesh, local_iters=local_iters,
                            donate=donate, compression=compression,
                            agg_impl=agg_impl)
    if population is not None:
        if ckpt:
            raise ValueError("ckpt= is not supported on the fleet "
                             "(population=) path")
        from repro_torch.fleet.engine import run_fleet
        from repro_torch.fleet.population import make_population
        pop = make_population(population)
        # virtual sharding: device id mod shards, so million-device
        # populations never materialize per-device token arrays
        data = lm_fleet_data(cfg, min(pop.size, 1024), seq=seq,
                             rows_per_device=max(n_seq // U, 4), seed=seed)
        return run_fleet(
            make_lm_model(cfg), pop, data=data, method=method, rounds=rounds,
            T_max=tmax, cohort_size=U, exec=spec, eta0=eta0, solver=solver,
            solver_steps=solver_steps or 600,
            eval_every=eval_every or max(rounds // 20, 1), seed=seed,
            verbose=verbose, replan=replan, eval_metrics=lm_eval_metrics,
            tracer=tracer, draws=draws, init_params=init_params, device=dev)

    task = lm_task(cfg, U=U, seq=seq, n_seq=n_seq, seed=seed)
    acfg = AnalysisConfig.default(U=U, L=task.model.L, R=rounds, T_max=tmax,
                                  eta0=eta0, seed=seed)
    comp = spec.compression
    if comp.mode != "none":
        # price the compressed wire into the Problem-2 plan: B_u shrinks by
        # the wire ratio, so the solved schedule spends the freed deadline
        # on larger batches
        n_params = sum(t.numel() for t in tree_leaves(task.model.init(
            torch.Generator().manual_seed(0), "meta")))
        acfg = dataclasses.replace(acfg, comm_scale=comp.wire_scale(),
                                   bytes_full=4.0 * n_params)
    schedule = None
    if method == "adel":
        kw = {"steps": solver_steps} if (solver == "adam"
                                         and solver_steps) else {}
        schedule = solve(acfg, solver, device=dev, **kw)
    policy = make_policy(method, acfg, schedule=schedule, device=dev)
    # the minibatch pad width prices EVERY client's round compute at
    # O(s_max) sequences, so it is capped: larger planned batches are
    # clipped by the sampler (only the straggler clock keeps the full one)
    s_max = max(min(probe_s_max(policy, rounds), s_max_cap,
                    4 * task.n_per_client), 2)
    runtime = RoundRuntime(task.model, policy, exec=spec, tracer=tracer,
                           device=dev)

    def save(params, step):
        save_checkpoint(ckpt, params, step=step,
                        meta={"arch": cfg.name, "method": method,
                              "backend": spec.backend})

    on_round = None
    if ckpt:
        every = ckpt_every or max(rounds // 4, 1)

        def on_round(t, params, hist):
            if (t + 1) % every == 0 or t == rounds - 1:
                save(params, t + 1)

    params, hist = runtime.run(
        task.source(dev), rounds=rounds, T_max=tmax, eta=acfg.eta,
        s_max=s_max, seed=seed, eval_fn=task.eval_fn(dev),
        eval_every=eval_every or max(rounds // 20, 1), verbose=verbose,
        method=method, replan=replan, on_round=on_round, draws=draws,
        init_params=init_params)
    if ckpt and (not hist.rounds or hist.rounds[-1] < rounds):
        # the budget ran out before the last planned round: keep the final
        # params the periodic hook may have missed
        save(params, hist.rounds[-1] if hist.rounds else 0)
    return params, hist


@contextlib.contextmanager
def _profile(trace_dir: str | None, device: torch.device):
    """Opt-in ``torch.profiler`` trace of the whole run (host, and the
    card's kernels on a CUDA device), written to ``trace_dir`` as a Chrome
    trace (view in Perfetto). A profiler that cannot start is reported and
    the run goes on without a trace."""
    if not trace_dir:
        yield
        return
    import os

    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    try:
        prof = profile(activities=acts)
        prof.__enter__()
    except RuntimeError as e:
        print(f"[train] torch.profiler unavailable ({e}); continuing "
              f"without a trace")
        yield
        return
    try:
        yield
    finally:
        prof.__exit__(None, None, None)
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, "train_trace.json")
        prof.export_chrome_trace(path)
        print(f"[train] trace -> {path}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Federated LM training (see module docstring)")
    ap.add_argument("--arch", default="hymba-1.5b")
    ap.add_argument("--method", default="adel",
                    choices=["adel", "salf", "drop", "wait", "heterofl"])
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--tmax", type=float, default=160.0)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--eta0", type=float, default=0.5)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--s-max-cap", type=int, default=32,
                    help="cap on the sequences a client trains a round")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="the 2-block smoke config (default)")
    ap.add_argument("--full", dest="reduced", action="store_false",
                    help="the arch at its published width and depth")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the arch to its first N blocks")
    ap.add_argument("--replan", default=None, choices=list(TRIGGERS),
                    help="online re-planning trigger "
                         "(repro_torch.core.replan)")
    ap.add_argument("--replan-every", type=int, default=None,
                    help="every-k re-plan period")
    # the shared execution-spec and population flag blocks, as in
    # repro_torch.fleet.scenarios; any population flag set routes the run
    # over a simulated device fleet (repro_torch.fleet.engine.run_fleet)
    ExecSpec.add_cli_args(ap)
    PopulationSpec.add_cli_args(ap)
    ap.add_argument("--solver", default="adam",
                    choices=["adam", "trust-constr"])
    ap.add_argument("--solver-steps", type=int, default=None)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--events", default=None, metavar="PATH",
                    help="write the structured telemetry stream (phase "
                         "spans, clock-model ledger) to this JSONL file; "
                         "render with python -m repro_torch.obs.timeline")
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the whole run "
                         "into DIR")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    replan = args.replan
    if replan is not None and args.replan_every is not None:
        replan = ReplanConfig(trigger=replan, every=args.replan_every)
    spec = ExecSpec.from_cli(args)
    pop_flags = (args.population, args.fleet_size, args.availability,
                 args.regions)
    pspec = (PopulationSpec.from_cli(args)
             if any(v is not None for v in pop_flags) else None)
    dev = resolve_device(args.device)
    tracer = obs.make_tracer(args.events)
    t0 = obs.now()
    with _profile(args.profile_dir, dev):
        _, hist = run_training(args.arch, method=args.method,
                               rounds=args.rounds, tmax=args.tmax,
                               U=args.clients, eta0=args.eta0, seq=args.seq,
                               seed=args.seed, reduced=args.reduced,
                               layers=args.layers,
                               solver=args.solver,
                               solver_steps=args.solver_steps, exec=spec,
                               replan=replan, population=pspec,
                               s_max_cap=args.s_max_cap, ckpt=args.ckpt,
                               tracer=tracer, device=dev)
    tracer.close()
    loss = hist.train_loss[-1]
    print(f"[train] done in {obs.now() - t0:.1f}s wall; "
          f"final token loss {loss:.4f} (ppl {math.exp(min(loss, 30)):.1f}, "
          f"token acc {hist.accuracy[-1]:.4f})")
    if args.events:
        print(f"[train] telemetry -> {args.events} (render: python -m "
              f"repro_torch.obs.timeline {args.events})")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({**hist.as_dict(), "arch": args.arch,
                       "backend": spec.backend,
                       "exec": spec.as_dict()}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
