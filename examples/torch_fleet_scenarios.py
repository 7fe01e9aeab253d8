"""Two contrasting fleets, side by side, on the PyTorch port.

Runs ADEL-FL against ``longtail-mobile-diurnal`` (heavy-tailed phone fleet
with day/night churn) and ``datacenter-always-on`` (homogeneous fast silo)
and prints the accuracy / deadline / availability trajectories next to
each other: the fleet substrate makes the *same* policy face radically
different populations.

``--replan`` turns on online deadline/batch re-planning
(``repro_torch.core.replan``): the remaining-horizon Problem 2 is
warm-start re-solved when the trigger fires, so the schedule tracks the
reachable population instead of the offline plan.

The port's counterpart of ``examples/fleet_scenarios.py``: its flags and
output, on the card unless ``--device cpu``.

Run:  PYTHONPATH=src python examples/torch_fleet_scenarios.py [--rounds N]
      PYTHONPATH=src python examples/torch_fleet_scenarios.py --replan drift
"""
import argparse
import dataclasses

from repro_torch.fleet.scenarios import get_scenario, run_scenario

NAMES = ("longtail-mobile-diurnal", "datacenter-always-on")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--fleet-size", type=int, default=300)
    ap.add_argument("--backend", default=None,
                    choices=["dense", "chunked", "shard_map", "temporal"],
                    help="execution backend (repro_torch.fl.backends); "
                         "default keeps the scenario's chunked engine")
    ap.add_argument("--replan", default=None,
                    choices=["never", "every-k", "drift"],
                    help="online re-planning trigger (repro_torch.core.replan)")
    ap.add_argument("--replan-every", type=int, default=None,
                    help="every-k re-plan period")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    runs = {}
    for name in NAMES:
        scn = dataclasses.replace(get_scenario(name), n_train=2000, n_test=400)
        print(f"== running {name} "
              f"(fleet={args.fleet_size}, rounds={args.rounds}) ==")
        runs[name] = run_scenario(scn, rounds=args.rounds,
                                  fleet_size=args.fleet_size,
                                  backend=args.backend,
                                  replan=args.replan,
                                  replan_every=args.replan_every,
                                  solver_steps=400, verbose=False,
                                  device=args.device)

    a, b = (runs[n] for n in NAMES)
    print(f"\n{'':8s} | {NAMES[0]:^34s} | {NAMES[1]:^34s}")
    print(f"{'round':8s} | {'acc':>7s} {'deadline':>9s} {'avail':>6s} "
          f"{'':8s} | {'acc':>7s} {'deadline':>9s} {'avail':>6s}")
    for i in range(max(len(a["rounds"]), len(b["rounds"]))):
        def cells(r):
            if i >= len(r["rounds"]):
                return f"{'—':>7s} {'—':>9s} {'—':>6s} {'':8s}"
            return (f"{r['accuracy'][i]:7.4f} {r['deadlines'][i]:9.3f} "
                    f"{r['available'][i]:6d} {'':8s}")
        rnd = (a["rounds"][i] if i < len(a["rounds"])
               else b["rounds"][i])
        print(f"{rnd:<8d} | {cells(a)} | {cells(b)}")
    print(f"\nfinal: {NAMES[0]} acc={a['accuracy'][-1]:.4f} "
          f"({a['wall_s']:.1f}s wall), "
          f"{NAMES[1]} acc={b['accuracy'][-1]:.4f} ({b['wall_s']:.1f}s wall)")
    for name in NAMES:
        r = runs[name]
        if r["replans"]:
            print(f"  {name} re-planned at rounds "
                  f"{[ev['round'] + 1 for ev in r['replans']]} "
                  f"(m -> {[round(ev['m'], 2) for ev in r['replans']]})")
    print("The datacenter fleet sustains near-full availability and tight "
          "deadlines; the long-tail mobile fleet loses a third of its "
          "devices to the diurnal cycle and pays for its stragglers.")
    return runs


if __name__ == "__main__":
    main()
