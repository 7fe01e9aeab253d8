"""Named fleet scenarios: fleet preset x availability x partition x policy
(port of ``repro.fleet.scenarios``).

A scenario bundles a :class:`repro_torch.configs.base.FleetConfig`
(population + cohort) with the data partition and the round policy, so
"run ADEL against ``longtail-mobile-diurnal``" names one experiment. The
registry holds the reference's scenarios with the reference's settings;
the CLI emits ``History`` dicts in the reference's JSON layout, and runs
on the card unless ``--device cpu`` is given:

    PYTHONPATH=src python -m repro_torch.fleet.scenarios --list
    PYTHONPATH=src python -m repro_torch.fleet.scenarios \
        --run longtail-mobile-diurnal --rounds 5 --device cpu
    PYTHONPATH=src python -m repro_torch.fleet.scenarios \
        --run datacenter-always-on --save out/fleet_scenarios.json

The LM scenario (``lm-uniform-bernoulli``) trains a reduced LM arch on
synthetic token-stream shards with token-loss eval, through the task
adapters of :mod:`repro_torch.fl.tasks`.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Optional

from repro_torch import obs
from repro_torch.configs.base import (CompressionConfig, ExecSpec,
                                      FleetConfig, ReplanConfig)
from repro_torch.core.compression import make_compression
from repro_torch.core.replan import TRIGGERS
from repro_torch.configs import get_config
from repro_torch.data.synthetic import make_image_dataset
from repro_torch.fl.tasks import lm_eval_metrics, lm_fleet_data, make_lm_model
from repro_torch.fleet.engine import partition_fleet, run_fleet
from repro_torch.fleet.population import PopulationSpec
from repro_torch.models.paper_models import make_cnn, make_mlp

__all__ = ["Scenario", "SCENARIOS", "get_scenario", "run_scenario",
           "save_scenario_result"]


@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    fleet: FleetConfig
    method: str = "adel"           # adel | salf | drop | wait
    model: str = "mlp"             # mlp | cnn | lm (reduced LM arch)
    alpha: Optional[float] = 0.5   # Dirichlet non-IID (None = IID)
    rounds: int = 20
    eta0: float = 2.0
    n_train: int = 4000
    n_test: int = 400
    arch: str = "qwen1.5-4b"       # model == "lm" only: the arch id
    note: str = ""


def _scn(name, preset, size, availability, akw=(), method="adel",
         strategy="uniform", alpha=0.5, note="", cohort=32,
         replan=ReplanConfig(), compression=CompressionConfig(),
         exec=None, population=None, regions=1, **kw) -> Scenario:
    return Scenario(
        name=name, method=method, alpha=alpha, note=note,
        fleet=FleetConfig(preset=preset, size=size, availability=availability,
                          availability_kwargs=tuple(akw),
                          cohort_strategy=strategy, cohort_size=cohort,
                          replan=replan, compression=compression,
                          exec=exec, population=population, regions=regions),
        **kw)


SCENARIOS = {s.name: s for s in [
    _scn("longtail-mobile-diurnal", "longtail-mobile", 600, "diurnal",
         akw=(("mean", 0.6), ("amplitude", 0.35), ("period", 12.0)),
         note="mass-market phones in time zones; ADEL under churny long tail"),
    _scn("datacenter-always-on", "datacenter", 512, "always-on",
         note="homogeneous fast silo — the deadline solver's easy regime"),
    _scn("bimodal-edge-markov", "bimodal-edge", 500, "markov",
         akw=(("p_off_to_on", 0.35), ("p_on_to_off", 0.12)),
         strategy="stratified",
         note="edge boxes with sticky outages; stratified tier coverage"),
    _scn("uniform-bernoulli-salf", "uniform", 500, "bernoulli",
         akw=(("rate", 0.7),), method="salf",
         note="SALF baseline under iid 70% availability"),
    _scn("bimodal-edge-heterofl", "bimodal-edge", 500, "markov",
         akw=(("p_off_to_on", 0.35), ("p_on_to_off", 0.12)),
         method="heterofl", strategy="stratified",
         note="HeteroFL width scaling on the same sticky-outage edge fleet "
              "as bimodal-edge-markov: slow boxes train narrow submodels"),
    _scn("longtail-mobile-power-of-choice", "longtail-mobile", 600, "diurnal",
         akw=(("mean", 0.6), ("amplitude", 0.35), ("period", 12.0)),
         strategy="power-of-choice",
         note="same population as longtail-mobile-diurnal, capability-biased "
              "cohort selection"),
    _scn("longtail-mobile-diurnal-replan", "longtail-mobile", 300, "diurnal",
         akw=(("mean", 0.42), ("amplitude", 0.5), ("period", 14.0),
              ("phase_spread", 0.5)),
         cohort=48, rounds=14,
         replan=ReplanConfig(trigger="drift", drift_threshold=0.3,
                             steps=300),
         note="one dominant time zone: the reachable count itself swings "
              "274 -> ~0 -> back, night rounds skip entirely; drift-"
              "triggered re-planning re-solves the remaining horizon and "
              "reclaims the stranded deadline budget"),
    _scn("bimodal-edge-markov-replan", "bimodal-edge", 500, "markov",
         akw=(("p_off_to_on", 0.35), ("p_on_to_off", 0.12)),
         strategy="stratified", cohort=32, rounds=14,
         replan=ReplanConfig(trigger="every-k", every=4, steps=300),
         note="same sticky-outage edge fleet as bimodal-edge-markov with "
              "periodic every-k re-solves tracking the un-spent budget and "
              "the Markov-relaxed reachable forecast"),
    _scn("longtail-mobile-diurnal-int8", "longtail-mobile", 600, "diurnal",
         akw=(("mean", 0.6), ("amplitude", 0.35), ("period", 12.0)),
         compression=CompressionConfig(mode="int8"),
         note="same population and seeds as longtail-mobile-diurnal with "
              "int8 client->server payloads: the reduction consumes the "
              "quantized wire format and the solver prices B_u at 1/4 — "
              "the matched-accuracy compression comparison"),
    _scn("longtail-mobile-buffered", "longtail-mobile", 600, "diurnal",
         akw=(("mean", 0.6), ("amplitude", 0.35), ("period", 12.0)),
         exec=ExecSpec(backend="buffered", lam=0.5),
         note="same population and seeds as longtail-mobile-diurnal on the "
              "buffered semi-async backend: layers a straggler misses at "
              "the deadline are carried server-side and folded into later "
              "rounds with staleness weight 0.5**tau"),
    _scn("bimodal-edge-buffered-salf", "bimodal-edge", 500, "markov",
         akw=(("p_off_to_on", 0.35), ("p_on_to_off", 0.12)),
         method="salf", strategy="stratified",
         exec=ExecSpec(backend="buffered", lam=0.6, max_age=3),
         note="fixed-deadline SALF + carry buffer on the sticky-outage "
              "edge fleet: the deadline never adapts, so the buffered "
              "delayed gradients are the only channel recovering the "
              "stragglers' unfinished layers"),
    _scn("lm-uniform-bernoulli", "uniform", 60, "bernoulli",
         akw=(("rate", 0.7),), model="lm", cohort=8, rounds=8, eta0=0.5,
         note="reduced LM arch on synthetic token streams against a churny "
              "fleet — the task-adapter path: same RoundRuntime, LM cohort "
              "source + token-loss eval via repro.fl.tasks"),
    _scn("longtail-mobile-1m-hierarchical", "longtail-mobile", 1_000_000,
         "bernoulli", akw=(("rate", 0.7),),
         population="parametric:longtail-mobile", regions=4,
         exec=ExecSpec(backend="hierarchical", regions=4),
         rounds=6,
         note="one million lazily-drawn devices (parametric population, "
              "O(cohort) per round) aggregated through 4 edge regions: "
              "per-region partials against global counts, one global Eq. 5 "
              "fold — the two-tier topology of planet-scale deployments"),
]}


def get_scenario(name: str) -> Scenario:
    if name not in SCENARIOS:
        raise KeyError(f"unknown scenario {name!r}; known: {sorted(SCENARIOS)}")
    return SCENARIOS[name]


def run_scenario(scn: Scenario, *, rounds: Optional[int] = None,
                 fleet_size: Optional[int] = None,
                 cohort_size: Optional[int] = None,
                 exec: Optional[ExecSpec] = None,
                 backend: Optional[str] = None,
                 population: Optional[PopulationSpec] = None,
                 replan=None, replan_every: Optional[int] = None,
                 compression=None, topk_frac: Optional[float] = None,
                 seed: int = 0,
                 solver_steps: int = 600, eval_every: int = 1,
                 verbose: bool = True, events: Optional[str] = None,
                 tracer=None, device=None) -> dict:
    """Run one scenario on ``device`` (the card unless the caller passes
    another); returns the History dict plus the fleet and availability
    descriptions, in the reference's layout.

    ``exec`` (:class:`repro_torch.fl.spec.ExecSpec`) overrides the scenario's
    execution spec wholesale; the ``backend`` / ``compression`` /
    ``topk_frac`` kwargs remain as deprecated aliases layered on the
    FleetConfig's resolved spec (:meth:`FleetConfig.exec_spec`) through
    the same :meth:`ExecSpec.resolve` path. ``population``
    (:class:`repro_torch.fleet.population.PopulationSpec` or a source string)
    likewise overrides WHO the scenario runs against wholesale
    (:meth:`FleetConfig.population_spec` is the base). ``replan`` (trigger
    name or ``ReplanConfig``) and ``replan_every`` override the
    FleetConfig's online re-planning block. ``events`` writes the
    structured telemetry stream (phase spans, clock-model ledger, the
    buffered backend's carry columns, the hierarchical backend's region
    census) to a JSONL file for ``python -m repro_torch.obs.timeline``;
    ``tracer`` passes an already-built :class:`repro_torch.obs.Tracer`
    instead (the caller keeps ownership — it is not closed here)."""
    fc = scn.fleet
    if fleet_size is not None:
        fc = dataclasses.replace(fc, size=fleet_size)
    if cohort_size is not None:
        fc = dataclasses.replace(fc, cohort_size=cohort_size)
    if replan is not None:
        rp = (replan if isinstance(replan, ReplanConfig)
              else dataclasses.replace(fc.replan, trigger=replan))
        fc = dataclasses.replace(fc, replan=rp)
    if replan_every is not None:
        fc = dataclasses.replace(
            fc, replan=dataclasses.replace(fc.replan, every=replan_every))
    spec = ExecSpec.resolve(
        exec, base=fc.exec_spec(), backend=backend,
        compression=(make_compression(compression)
                     if compression is not None else None))
    if topk_frac is not None:
        spec = dataclasses.replace(
            spec, compression=dataclasses.replace(spec.compression,
                                                  top_k=float(topk_frac)))
    rounds = scn.rounds if rounds is None else rounds

    pspec = fc.population_spec()
    if population is not None:
        pspec = (population if isinstance(population, PopulationSpec)
                 else PopulationSpec.resolve(base=pspec, source=population))
    # availability seeded with fc.seed + run seed, as the reference seeds
    # it
    pop = pspec.build(avail_seed=fc.seed + seed)
    # virtual data sharding (device id mod shards) caps the partition at
    # 1024 shards, so million-device populations never materialize
    # per-device arrays; smaller populations keep one shard a device
    n_shards = min(pop.size, 1024)
    eval_m = None
    if scn.model == "lm":
        # the task-adapter path: the same runtime trains a reduced LM arch
        # on token-stream shards with token-loss eval (repro_torch.fl.tasks)
        arch_cfg = get_config(scn.arch).reduced()
        model = make_lm_model(arch_cfg)
        data = lm_fleet_data(arch_cfg, n_shards, seq=32, rows_per_device=16,
                             seed=seed)
        eval_m = lm_eval_metrics
    else:
        x_tr, y_tr, x_te, y_te = make_image_dataset(
            "mnist", n_train=scn.n_train, n_test=scn.n_test, seed=seed,
            noise_std=1.0)
        data = partition_fleet(x_tr, y_tr, x_te, y_te, n_shards,
                               alpha=scn.alpha, seed=seed)
        model = make_cnn() if scn.model == "cnn" else make_mlp()

    own_tracer = tracer is None and events is not None
    if own_tracer:
        tracer = obs.make_tracer(events)
    t0 = obs.now()
    try:
        _, hist = run_fleet(
            model, pop, data=data, method=scn.method, rounds=rounds,
            cohort_size=fc.cohort_size, cohort_strategy=fc.cohort_strategy,
            exec=spec, eta0=scn.eta0,
            solver_steps=solver_steps, eval_every=eval_every, seed=seed,
            verbose=verbose, replan=fc.replan, eval_metrics=eval_m,
            tracer=tracer, device=device)
    finally:
        if own_tracer:
            tracer.close()
    out = hist.as_dict()
    out["wall_s"] = round(obs.now() - t0, 2)
    if events is not None:
        out["events_path"] = os.path.abspath(events)
    out["scenario"] = scn.name
    desc = pop.describe()
    out["fleet"] = desc["fleet"]
    out["availability"] = desc["availability"]
    out["population"] = pspec.as_dict()
    out["cohort"] = {"size": fc.cohort_size, "strategy": fc.cohort_strategy}
    out["backend"] = spec.backend
    out["replan"] = dataclasses.asdict(fc.replan)
    out["compression"] = dataclasses.asdict(spec.compression)
    out["exec"] = spec.as_dict()
    return out


def save_scenario_result(name: str, method: str, result: dict,
                         path: str) -> str:
    """Merge one run into the JSON file at ``path`` (the caller's), in the
    reference's {setting: {method: history}} layout."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = {}
    if os.path.exists(path):
        with open(path) as f:
            payload = json.load(f)
    payload.setdefault(name, {})[method] = result
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
    return os.path.abspath(path)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Fleet-scenario runner (see module docstring)")
    ap.add_argument("--list", action="store_true", help="list scenarios")
    ap.add_argument("--run", default=None, metavar="NAME")
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--cohort", type=int, default=None)
    ap.add_argument("--replan", default=None, choices=list(TRIGGERS),
                    help="online re-planning trigger override "
                         "(repro_torch.core.replan; scenarios carry their "
                         "own default in FleetConfig.replan)")
    ap.add_argument("--replan-every", type=int, default=None,
                    help="every-k re-plan period override")
    # the execution-spec flag block (--backend / --compression /
    # --topk-frac / --agg-impl / --lam / ...), from ExecSpec
    ExecSpec.add_cli_args(ap)
    # the population flag block (--population / --fleet-size /
    # --availability / --regions), from PopulationSpec
    PopulationSpec.add_cli_args(ap)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--solver-steps", type=int, default=600)
    ap.add_argument("--events", default=None, metavar="PATH",
                    help="write the structured telemetry stream (phase "
                         "spans, clock-model ledger) to this JSONL file; "
                         "render with python -m repro_torch.obs.timeline")
    ap.add_argument("--save", default=None, metavar="PATH",
                    help="merge the History into the JSON file at PATH")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    if args.list or not args.run:
        print(f"{'scenario':38s} {'fleet':28s} {'avail':10s} "
              f"{'cohort':22s} {'method':9s} {'backend':9s} replan")
        for s in SCENARIOS.values():
            fc = s.fleet
            print(f"{s.name:38s} {fc.preset + ' x' + str(fc.size):28s} "
                  f"{fc.availability:10s} "
                  f"{str(fc.cohort_size) + ' ' + fc.cohort_strategy:22s} "
                  f"{s.method:9s} {fc.exec_spec().backend:9s} "
                  f"{fc.replan.trigger}")
            if s.note:
                print(f"    {s.note}")
        return

    try:
        scn = get_scenario(args.run)
    except KeyError as e:
        ap.error(str(e.args[0]))
    spec = ExecSpec.from_cli(args, base=scn.fleet.exec_spec())
    pop_flags = (args.population, args.fleet_size, args.availability,
                 args.regions)
    pspec = (PopulationSpec.from_cli(args,
                                     base=scn.fleet.population_spec())
             if any(v is not None for v in pop_flags) else None)
    res = run_scenario(scn, rounds=args.rounds,
                       cohort_size=args.cohort, exec=spec, population=pspec,
                       replan=args.replan, replan_every=args.replan_every,
                       seed=args.seed, solver_steps=args.solver_steps,
                       verbose=not args.quiet, events=args.events,
                       device=args.device)
    acc = res["accuracy"][-1] if res["accuracy"] else float("nan")
    rounds_done = res["rounds"][-1] if res["rounds"] else 0
    print(f"[{scn.name}] method={scn.method} fleet={res['fleet']['size']} "
          f"rounds={rounds_done} final_acc={acc:.4f} "
          f"wall={res['wall_s']:.1f}s")
    print(f"  avail/round: {res['available']}")
    print(f"  deadlines:   {[round(d, 3) for d in res['deadlines']]}")
    if res["replans"]:
        print(f"  replans:     "
              f"{[(r['round'], r['U_est'], round(r['m'], 2)) for r in res['replans']]}")
    if args.events:
        print(f"  events:      {res['events_path']} "
              f"(render: python -m repro_torch.obs.timeline {args.events})")
    if args.save:
        path = save_scenario_result(scn.name, scn.method, res, args.save)
        print(f"  saved -> {path}")


if __name__ == "__main__":
    main()
