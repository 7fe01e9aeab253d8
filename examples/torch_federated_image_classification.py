"""End-to-end driver on the PyTorch port: the paper's CIFAR-like
experiment (Section IV-B).

Trains a (width-reduced) VGG11 across 12 Dirichlet(0.5) non-IID clients
under a total time budget, comparing ADEL-FL against every baseline the
paper uses (SALF / Drop-Stragglers / Wait-Stragglers), and prints an ASCII
convergence chart. This is the runnable counterpart of Fig. 3.

The port's counterpart of ``examples/federated_image_classification.py``:
its flags and output, on the card unless ``--device cpu``.

Run:  PYTHONPATH=src python examples/torch_federated_image_classification.py
      [--rounds 20] [--methods adel,salf,drop,wait]
"""
import argparse
import json
import os

from repro_torch.core.baselines import make_policy
from repro_torch.core.scheduler import solve
from repro_torch.core.types import AnalysisConfig
from repro_torch.data.synthetic import make_image_dataset
from repro_torch.device import resolve_device
from repro_torch.fl.partition import dirichlet_partition, stack_clients
from repro_torch.fl.server import run_federated
from repro_torch.models.paper_models import make_vgg


def ascii_chart(histories: dict, width: int = 60, height: int = 12) -> str:
    t_max = max(h.times[-1] for h in histories.values())
    rows = [[" "] * width for _ in range(height)]
    marks = {}
    for i, (name, h) in enumerate(histories.items()):
        ch = name[0].upper()
        marks[ch] = name
        for t, a in zip(h.times, h.accuracy):
            x = min(int(t / t_max * (width - 1)), width - 1)
            y = min(int(a * (height - 1)), height - 1)
            rows[height - 1 - y][x] = ch
    lines = ["accuracy"]
    for r, row in enumerate(rows):
        frac = (height - 1 - r) / (height - 1)
        lines.append(f"{frac:4.2f} |" + "".join(row))
    lines.append("     +" + "-" * width + f"> time (0..{t_max:.0f}s)")
    lines.append("     " + "  ".join(f"{c}={n}" for c, n in marks.items()))
    return "\n".join(lines)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rounds", type=int, default=60)
    ap.add_argument("--clients", type=int, default=12)
    ap.add_argument("--methods", default="adel,salf,drop,wait")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    model = make_vgg(11, width_scale=0.125)
    x_tr, y_tr, x_te, y_te = make_image_dataset(
        "cifar", n_train=1000, n_test=300, seed=0)
    parts = dirichlet_partition(y_tr, args.clients, alpha=0.5, seed=0)
    cx, cy, counts = stack_clients(x_tr, y_tr, parts)

    # avg backprop depth ~85% of layers, as in the paper's CIFAR setup;
    # slow inverse decay (deep conv net, few rounds)
    cfg = AnalysisConfig.default(U=args.clients, L=model.L, R=args.rounds,
                                 T_max=args.rounds * model.L * 0.85,
                                 eta0=0.05, eta_decay=0.02, seed=0)
    schedule = solve(cfg, "adam", steps=800, device=dev)
    print(f"[schedule] m={schedule.m:.2f}  "
          f"T: {schedule.T[0]:.2f} .. {schedule.T[-1]:.2f}")

    histories = {}
    for method in args.methods.split(","):
        policy = make_policy(method, cfg, device=dev,
                             schedule=schedule if method == "adel" else None)
        _, hist = run_federated(model, policy, cfg, cx, cy, counts, x_te,
                                y_te, seed=0, eval_every=2, verbose=True,
                                device=dev)
        histories[method] = hist

    print()
    print(ascii_chart(histories))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({k: h.as_dict() for k, h in histories.items()}, f,
                      indent=1)
        print(f"saved {args.out}")
    return histories


if __name__ == "__main__":
    main()
