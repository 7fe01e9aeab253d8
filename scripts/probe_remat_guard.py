#!/usr/bin/env python3
"""Host cost of a guard that would make every second derivative through
``remat`` raise, on the card.

    python3 scripts/probe_remat_guard.py [--pairs 5] [--rows 6] [--seq 256]

``_Remat``'s backward recomputes a block under no grad when it runs under
one ``torch.func`` grad level (``torch.func.grad`` asks for
``create_graph=True`` whether or not a second derivative follows). A
second derivative that autograd takes inside such a grad then misses the
block's terms. The guard measured here ties each block's grads to a node
whose backward raises, so that case fails instead. It is defined here, not
in the package. hymba-1.5b at full width (f32 params, bf16 compute): one
client's spatial ``make_train_step`` (its ``vmap(grad)``) three ways, in
turns: remat as the package has it, remat with the guard, and no remat.
Prints each call's wall, each way's median, its peak memory above the
step's start, and whether its update is bit-identical to the package's.
"""
from __future__ import annotations

import argparse
import gc
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def guarded_backward():
    """``_Remat.backward`` with every grad passed through a node, tied to
    the block's input and cotangents, whose backward raises."""
    import torch

    class Guard(torch.autograd.Function):
        @staticmethod
        def forward(n, *args):
            return tuple(g.view_as(g) for g in args[:n])

        @staticmethod
        def setup_context(ctx, inputs, output):
            pass

        @staticmethod
        def vmap(info, in_dims, n, *args):
            return Guard.forward(n, *args), tuple(in_dims[1:n + 1])

        @staticmethod
        def backward(ctx, *_):
            raise RuntimeError("a second derivative through remat")

    def backward(ctx, *cotangents):
        create_graph = torch.is_grad_enabled()
        with torch.no_grad():
            _, vjp = torch.func.vjp(ctx.fn, *ctx.saved_tensors)
            grads = vjp(cotangents, create_graph=create_graph)
        if create_graph:
            grads = Guard.apply(len(grads), *grads, ctx.saved_tensors[0],
                                *cotangents)
        return (None, *grads)

    return staticmethod(backward)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--rows", type=int, default=6)
    ap.add_argument("--seq", type=int, default=256)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("probe_remat_guard: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as tr
    from repro_torch.tree import tree_leaves

    cfg = get_config("hymba-1.5b")
    gen = torch.Generator(device="cuda").manual_seed(17)
    params = tr.init_params(gen, cfg, device="cuda")
    tok = torch.randint(0, cfg.vocab, (1, args.rows, args.seq), generator=gen,
                        device="cuda")
    step_args = (tok, tok, torch.ones((1, cfg.L), device="cuda"),
                 torch.full((cfg.L,), 0.05, device="cuda"), 0.1)
    package = tr._Remat.__dict__["backward"]
    ways = {"package": (True, package), "guard": (True, guarded_backward()),
            "no_remat": (False, package)}
    steps = {w: make_train_step(cfg, U=1, mode="spatial", remat=r)
             for w, (r, _) in ways.items()}

    def run(way):
        tr._Remat.backward = ways[way][1]
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = steps[way](params, *step_args)
            torch.cuda.synchronize()
            return out, 1e3 * (time.perf_counter() - t0)
        finally:
            tr._Remat.backward = package

    peaks, same, ref = {}, {}, None
    for way in ways:                    # warm-up, peak; the package's kept
        gc.collect()                    # an earlier step's graph in a cycle
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out, _ = run(way)
        peaks[way] = (torch.cuda.max_memory_allocated() - base) / 1e9
        if ref is None:
            ref = tree_leaves(out)
        same[way] = all(torch.equal(a, b)
                        for a, b in zip(ref, tree_leaves(out)))
        del out
    del ref
    walls = {w: [] for w in ways}
    order = list(ways)
    for i in range(args.pairs):
        for way in (order if i % 2 == 0 else order[::-1]):
            walls[way].append(run(way)[1])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    for way in ways:
        print(f"[remat guard] {card} hymba-1.5b spatial U=1 b={args.rows} "
              f"seq={args.seq} {way}: median_wall_ms="
              + (f"{statistics.median(walls[way]):.3f}" if walls[way]
                 else "not measured") + " walls_ms="
              f"{[round(w, 3) for w in walls[way]]} peak_above_start_gb="
              f"{peaks[way]:.2f} bit_identical_to_package={same[way]}",
              flush=True)
    slower = sum(g > p for g, p in zip(walls["guard"], walls["package"]))
    print(f"[remat guard] guard slower than the package in {slower} of "
          f"{args.pairs} turns", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
