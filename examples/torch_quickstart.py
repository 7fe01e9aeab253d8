"""Quickstart on the PyTorch port: the ADEL-FL pipeline in ~60 lines.

1. Build the analysis constants (Table I of the paper).
2. Solve Problem 2 (jointly optimal deadlines {T_t^d} and batch scale m).
3. Run a small federated round loop (layer-wise aggregation, Eq. 5, through
   the hand-written fold kernel on the card) on a synthetic MNIST-like task
   and compare ADEL-FL against Drop-Stragglers.

The port's counterpart of ``examples/quickstart.py``: the same flags-free
run and output, on the card unless ``--device cpu``.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core.baselines import make_policy
from repro_torch.core.scheduler import solve
from repro_torch.core.types import AnalysisConfig
from repro_torch.data.synthetic import make_image_dataset
from repro_torch.device import resolve_device
from repro_torch.fl.partition import dirichlet_partition, stack_clients
from repro_torch.fl.server import run_federated
from repro_torch.models.paper_models import make_mlp


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # --- data: 10 clients, Dirichlet(0.5) non-IID split -------------------
    x_tr, y_tr, x_te, y_te = make_image_dataset(
        "mnist", n_train=1500, n_test=400, seed=0)
    U = 10
    parts = dirichlet_partition(y_tr, U, alpha=0.5, seed=0)
    cx, cy, counts = stack_clients(x_tr, y_tr, parts)

    # --- model + analysis constants (A1-A3, B1-B3) ------------------------
    model = make_mlp()
    cfg = AnalysisConfig.default(U=U, L=model.L, R=25, T_max=60.0,
                                 eta0=2.0, seed=3)

    # --- Problem 2: optimal deadlines + batch scale ------------------------
    schedule = solve(cfg, "adam", steps=800, device=dev)
    print(f"batch scale m = {schedule.m:.3f}")
    print("deadlines T_t^d:", np.round(schedule.T[:6], 2), "...",
          np.round(schedule.T[-3:], 2))
    print("batch sizes S_1^u:", schedule.batch_sizes(cfg)[0])

    # --- run ADEL-FL vs Drop-Stragglers ------------------------------------
    histories = {}
    for method in ("adel", "drop"):
        policy = make_policy(method, cfg, device=dev,
                             schedule=schedule if method == "adel" else None)
        _, hist = run_federated(model, policy, cfg, cx, cy, counts, x_te,
                                y_te, seed=0, eval_every=5, device=dev)
        print(f"[{method:5s}] final accuracy {hist.accuracy[-1]:.3f} "
              f"after {hist.rounds[-1]} rounds "
              f"({hist.times[-1]:.1f}s simulated)")
        histories[method] = hist
    return histories


if __name__ == "__main__":
    main()
