"""Explore the Problem-2 deadline/batch solution space (paper Fig. 2a/3a)
on the PyTorch port.

Solves the ADEL-FL scheduling problem for several time budgets and
heterogeneity spreads, and prints the resulting deadline profiles, showing
the paper's headline qualitative result: deadlines DECREASE over rounds,
tracking the decaying learning rate (early rounds buy straggler depth when
updates matter most).

The port's counterpart of ``examples/schedule_explorer.py``: its output,
on the card unless ``--device cpu`` (``--steps`` sets the solver's Adam
steps, 800 as the reference's).

Run:  PYTHONPATH=src python examples/torch_schedule_explorer.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core.cost import b_term, c_term, theorem1_bound
from repro_torch.core.scheduler import solve
from repro_torch.core.types import AnalysisConfig
from repro_torch.device import resolve_device


def spark(values, width: int = 40) -> str:
    blocks = " .:-=+*#%@"
    v = np.asarray(values, float)
    idx = np.linspace(0, len(v) - 1, width).astype(int)
    v = v[idx]
    t = (v - v.min()) / max(v.max() - v.min(), 1e-12)
    return "".join(blocks[int(x * (len(blocks) - 1))] for x in t)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--steps", type=int, default=800,
                    help="Adam steps of each solve")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    R, U, L = 30, 12, 10
    profiles = {}
    print(f"{'T_max':>7s} {'spread':>7s} {'m':>6s} "
          f"{'T_1':>6s} {'T_R':>6s}  deadline profile (round 1..R)")
    for t_max in (60.0, 120.0, 240.0):
        for spread in (2.0, 8.0):
            cfg = AnalysisConfig.default(U=U, L=L, R=R, T_max=t_max,
                                         eta0=0.5, seed=0,
                                         het_spread=spread)
            sch = solve(cfg, "adam", steps=args.steps, device=dev)
            profiles[(t_max, spread)] = sch
            print(f"{t_max:7.0f} {spread:7.1f} {sch.m:6.2f} "
                  f"{sch.T[0]:6.2f} {sch.T[-1]:6.2f}  {spark(sch.T)}")

    # decompose the Theorem-1 objective for one setting: B_t vs C_t trade-off
    cfg = AnalysisConfig.default(U=U, L=L, R=R, T_max=120.0, eta0=0.5, seed=0)
    sch = solve(cfg, "adam", steps=args.steps, device=dev)
    T = torch.as_tensor(np.asarray(sch.T), dtype=torch.float32, device=dev)

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    print("\nTheorem-1 terms at the optimum (round 1, mid, R):")
    bt = b_term(T, f32(sch.m), cfg).cpu().numpy()
    ct = c_term(T, f32(sch.m), cfg).cpu().numpy()
    for t in (0, R // 2, R - 1):
        print(f"  t={t + 1:2d}: B_t={bt[t]:9.3f}  C_t={ct[t]:9.3f}")
    print(f"objective (Theorem-1 bound) = "
          f"{float(theorem1_bound(T, f32(sch.m), cfg)):.4f}")

    print("\nm sensitivity (C_t explodes as m grows at fixed deadlines):")
    for m_try in (0.5 * sch.m, sch.m, 2.0 * sch.m, 4.0 * sch.m):
        val = float(theorem1_bound(T, f32(m_try), cfg))
        print(f"  m={m_try:6.2f}: bound={val:10.4f}"
              + ("   <- optimum" if abs(m_try - sch.m) < 1e-9 else ""))
    return {"profiles": profiles, "optimum": sch}


if __name__ == "__main__":
    main()
