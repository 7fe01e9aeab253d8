"""ADEL-FL on an assigned billion-scale architecture, on the PyTorch port
(reduced size).

Runs REAL federated rounds of a reduced ``--arch`` config on synthetic
token streams through the port's round runtime: Problem-2 schedule ->
straggler depth draws (B1) -> deadline-truncated layer-wise aggregation
(Eq. 5, the grouped fold kernel on the card) -> SGD. Every execution
backend works here (``--backend temporal`` is the grad-accumulation client
layout the big archs need), and so do online re-planning (``--replan
every-k``) and HeteroFL (``--method heterofl``).

The port's counterpart of ``examples/federated_llm_round.py``: its flags
and output, on the card unless ``--device cpu``.

Run:  PYTHONPATH=src python examples/torch_federated_llm_round.py --arch qwen1.5-4b
      (any of the 10 assigned --arch ids works; see repro_torch/configs)
"""
import argparse
import math

from repro_torch.fl.backends import BACKENDS
from repro_torch.launch.train import run_training


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen1.5-4b")
    ap.add_argument("--method", default="adel",
                    choices=["adel", "salf", "drop", "wait", "heterofl"])
    ap.add_argument("--rounds", type=int, default=24)
    ap.add_argument("--tmax", type=float, default=120.0)
    ap.add_argument("--backend", default="temporal", choices=list(BACKENDS))
    ap.add_argument("--replan", default=None,
                    choices=["never", "every-k", "drift"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    _, hist = run_training(args.arch, method=args.method, rounds=args.rounds,
                           tmax=args.tmax, U=6, seq=48, eta0=1.0,
                           backend=args.backend, replan=args.replan,
                           verbose=True, device=args.device)
    first, last = hist.train_loss[0], hist.train_loss[-1]
    print(f"\n[{args.arch}] {args.method} ({args.backend}): "
          f"token loss {first:.3f} -> {last:.3f} "
          f"(ppl {math.exp(min(last, 30)):.1f}, "
          f"token acc {hist.accuracy[-1]:.4f}) "
          f"over {hist.rounds[-1]} rounds "
          f"({hist.times[-1]:.1f}s simulated clock)")
    return hist


if __name__ == "__main__":
    main()
