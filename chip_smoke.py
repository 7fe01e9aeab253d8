#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit), the torch and
   CUDA versions, and both TF32 flags (set False: f32 means f32).
2. Builds the CUDA kernels from ``src/repro_torch/csrc`` with ``nvcc``.
3. Holds each kernel against its plain PyTorch version on the card at the
   main path's shapes (every VGG-11 leaf at U=10), a stacked and a ragged
   case, and for ``adel_agg_q8`` a zero-coefficient row and a zero-scale
   layer; times kernel, plain version and one ``torch.einsum`` (a yardstick
   the port never calls) as CUDA-graph replays, the kernel also as eager
   calls, and computes the bandwidth bound. Then one round's fold: all 38
   VGG-11 leaves, each kernel against its plain version, timed the same way.
4. Drives the main path at full width: ``run_federated`` on VGG-11
   (``width_scale=1.0``), synthetic CIFAR, U=10 Dirichlet(0.5) clients, the
   ADEL policy from ``solve(cfg, "adam")``, once uncompressed and once with
   int8 payloads; each kernel's launch count must be 38 leaves x rounds.
   A third, uncompressed run is profiled: device busy and idle time per
   round, the fold kernels' share, the top device kernels.
5. Runs the quickstart regime (MLP, R=25) on the card: accuracy > 0.3.
6. Prints the ``kernels`` JSON line (per-round fold times) and, last, the
   ``{"ok": true, ...}`` line.

Exits non-zero, printing no result, without a CUDA device or without the
repository's ``src/repro_torch`` beside it; any failed phase exits non-zero.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
# (rtol, atol) of a kernel against its plain version: f32 sums in another
# order; bf16 outputs may round one bf16 ulp apart (< 0.8%)
TOL = {"f32": (1e-5, 1e-5), "bf16": (1e-2, 1e-2), "q8": (1e-5, 1e-5)}
U_MAIN = 10
ROUNDS_MAIN = 5


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def call_ms(torch, fn, iters: int = 50, warmup: int = 10) -> float:
    """Mean time per call of ``fn()`` in an eager loop (CUDA events): what
    the main path pays per call, host-side wrapper included."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, reps: int = 20, replays: int = 5) -> float:
    """Device time per call of ``fn()``: ``reps`` calls captured in one CUDA
    graph and replayed, so host-side overhead is not in the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * reps)


def bound_ms(bytes_moved: float, flops: float) -> float:
    """Least time on the card: bytes over HBM rate or f32 operations over the
    f32 rate, whichever is larger."""
    return 1e3 * max(bytes_moved / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)


def agg_bytes(U: int, L: int, F: int, itemsize: int) -> int:
    """adel_agg reads grads and coeff (f32) once and writes the output."""
    return U * L * F * itemsize + U * L * 4 + L * F * itemsize


def q8_bytes(U: int, L: int, F: int) -> int:
    """adel_agg_q8 reads q, scales and coeff once and writes f32 output."""
    return U * L * F + 2 * U * L * 4 + L * F * 4


def vgg_leaf_features() -> dict:
    """{F: number of VGG-11 leaves of that flattened size} at full width."""
    import torch
    from repro_torch.models.paper_models import make_vgg
    from repro_torch.tree import tree_leaves
    model = make_vgg(11, width_scale=1.0)
    params = model.init(torch.Generator().manual_seed(0), "meta")
    counts: dict = {}
    for leaf in tree_leaves(params):
        counts[leaf.numel()] = counts.get(leaf.numel(), 0) + 1
    check(sum(counts.values()) == 38, f"VGG-11 has {sum(counts.values())} leaves")
    return dict(sorted(counts.items()))


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------

def quantize(torch, g):
    """The wire's int8 absmax quantization of (U, L, F) deltas."""
    amax = g.abs().amax(-1)
    inv = torch.where(amax > 0, 127.0 / amax, torch.zeros_like(amax))
    return torch.round(g * inv[..., None]).to(torch.int8), amax / 127.0


def kernel_cases(torch, leaf_F: dict) -> list:
    """Each kernel against its plain version at the main path's shapes and
    the edge cases; returns one row per case."""
    from repro_torch.kernels.adel_agg import (adel_agg, adel_agg_plain,
                                              adel_agg_q8, adel_agg_q8_plain)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def rand(*shape):
        return torch.rand(shape, generator=gen, device="cuda")

    rows = []

    def record(kernel, tag, dtype, shape, out, ref, fns, nbytes, flops):
        U, L, F = shape
        rtol, atol = TOL[dtype]
        err = (out.float() - ref.float()).abs()
        ok = bool((err <= atol + rtol * ref.float().abs()).all())
        row = {"kernel": kernel, "case": tag, "dtype": dtype, "U": U, "L": L,
               "F": F, "max_abs_err": float(err.max()), "rtol": rtol,
               "atol": atol, "ok": ok,
               "kernel_ms": graph_ms(torch, fns[0]),
               "call_ms": call_ms(torch, fns[0]),
               "plain_ms": graph_ms(torch, fns[1]),
               "library_ms": None if fns[2] is None else graph_ms(torch, fns[2]),
               "bound_ms": bound_ms(nbytes, flops)}
        lib = row["library_ms"]
        print(f"[kernel] {kernel:11s} {tag:8s} {dtype:4s} U={U:<3d} L={L:<3d} "
              f"F={F:<8d} max_abs_err={row['max_abs_err']:.3e} tol=rtol "
              f"{rtol:g}/atol {atol:g} kernel_ms={row['kernel_ms']:.5f} "
              f"call_ms={row['call_ms']:.5f} plain_ms={row['plain_ms']:.5f} "
              f"library_ms={'null' if lib is None else f'{lib:.5f}'} "
              f"bound_ms={row['bound_ms']:.5f} {'ok' if ok else 'FAIL'}",
              flush=True)
        check(ok, f"{kernel} {tag} {dtype} {shape} disagrees: "
                  f"{row['max_abs_err']}")
        rows.append(row)

    def q8_case(tag, q, s, c, ref=None):
        U, L, F = q.shape
        out = adel_agg_q8(q, s, c)
        check(out.shape == (L, F) and out.dtype == torch.float32, "q8 shape")
        record("adel_agg_q8", tag, "q8", (U, L, F), out,
               adel_agg_q8_plain(q, s, c) if ref is None else ref,
               (lambda: adel_agg_q8(q, s, c),
                lambda: adel_agg_q8_plain(q, s, c), None),
               q8_bytes(U, L, F), 2 * U * L * F)
        return out

    shapes = [("vgg", U_MAIN, 1, F) for F in leaf_F]
    shapes += [("stacked", 16, 24, 4096), ("ragged", 7, 5, 300)]
    for tag, U, L, F in shapes:
        g32 = randn(U, L, F)
        c = rand(U, L)
        for dtype, tdt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            g, ct = g32.to(tdt), c.to(tdt)
            out = adel_agg(g, c)
            check(out.shape == (L, F) and out.dtype == tdt, "adel_agg shape")
            record("adel_agg", tag, dtype, (U, L, F), out, adel_agg_plain(g, c),
                   (lambda: adel_agg(g, c), lambda: adel_agg_plain(g, c),
                    lambda: torch.einsum("ul,ulf->lf", ct, g)),
                   agg_bytes(U, L, F, g.element_size()), 2 * U * L * F)
        q8_case(tag, *quantize(torch, g32), c)

    # zero-coefficient rows: those clients contribute nothing
    U, L, F = U_MAIN, 1, 73728
    q, s = quantize(torch, randn(U, L, F))
    c = rand(U, L)
    c[[1, 4]] = 0.0
    keep = torch.tensor([u for u in range(U) if u not in (1, 4)],
                        device="cuda")
    q8_case("zerocoef", q, s, c,
            ref=adel_agg_q8_plain(q[keep], s[keep], c[keep]))
    # an all-zero delta layer quantizes to scale 0 and folds to exactly 0
    g = randn(U_MAIN, 2, 4096)
    g[:, 1] = 0.0
    out = q8_case("zerosc", *quantize(torch, g), rand(U_MAIN, 2))
    check(bool(torch.isfinite(out).all()) and bool((out[1] == 0).all()),
          "zero-scale layer does not fold to exactly zero")
    return rows


def fold_round(torch, leaf_F: dict) -> dict:
    """One round's fold on the main path: all 38 VGG-11 leaves at U=10, f32
    through ``adel_agg`` and int8 through ``adel_agg_q8``, each leaf in its
    own launch as the runtime issues them, timed as one CUDA graph (the
    inputs, 390 MB in f32, do not fit in the 50 MB L2)."""
    from repro_torch.kernels.adel_agg import (adel_agg, adel_agg_plain,
                                              adel_agg_q8, adel_agg_q8_plain)
    gen = torch.Generator(device="cuda").manual_seed(1)
    leaves = []
    for F, n in leaf_F.items():
        for _ in range(n):
            g = torch.randn((U_MAIN, 1, F), generator=gen, device="cuda")
            c = torch.rand((U_MAIN, 1), generator=gen, device="cuda")
            leaves.append((g, c) + quantize(torch, g))
    n_el = sum(g.numel() for g, *_ in leaves)
    F_tot = n_el // U_MAIN
    out = {}
    for name, kern, plain, lib, nbytes in (
            ("adel_agg", lambda g, c, q, s: adel_agg(g, c),
             lambda g, c, q, s: adel_agg_plain(g, c),
             lambda g, c, q, s: torch.einsum("ul,ulf->lf", c, g),
             sum(agg_bytes(U_MAIN, 1, a[0].shape[2], 4) for a in leaves)),
            ("adel_agg_q8", lambda g, c, q, s: adel_agg_q8(q, s, c),
             lambda g, c, q, s: adel_agg_q8_plain(q, s, c), None,
             sum(q8_bytes(U_MAIN, 1, a[0].shape[2]) for a in leaves))):
        err = max(float((kern(*a) - plain(*a)).abs().max()) for a in leaves)
        rnd = {"ms": graph_ms(torch, lambda: [kern(*a) for a in leaves],
                              reps=3),
               "call_ms": call_ms(torch, lambda: [kern(*a) for a in leaves],
                                  iters=5, warmup=2),
               "plain_ms": graph_ms(torch, lambda: [plain(*a) for a in leaves],
                                    reps=3),
               "library_ms": None if lib is None else graph_ms(
                   torch, lambda: [lib(*a) for a in leaves], reps=3),
               "bound_ms": bound_ms(nbytes, 2 * n_el), "max_abs_err": err,
               "bytes": nbytes}
        print(f"[fold round] {name:11s} 38 leaves U={U_MAIN} F_total={F_tot} "
              f"bytes={nbytes} max_abs_err={err:.3e} "
              + " ".join(f"{k}={'null' if v is None else f'{v:.5f}'}"
                         for k, v in rnd.items()
                         if k.endswith("ms")), flush=True)
        check(err <= 1e-5 * (1 + max(float(plain(*a).abs().max())
                                     for a in leaves)),
              f"{name} round fold disagrees with its plain version: {err}")
        out[name] = rnd
    return out


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------

def vgg_runs(torch) -> dict:
    from repro_torch.core.baselines import make_policy
    from repro_torch.core.scheduler import solve
    from repro_torch.core.types import AnalysisConfig
    from repro_torch.data.synthetic import make_image_dataset
    from repro_torch.fl.partition import dirichlet_partition, stack_clients
    from repro_torch.fl.server import run_federated
    from repro_torch.kernels.adel_agg import adel_agg, adel_agg_q8
    from repro_torch.models.paper_models import make_vgg

    x_tr, y_tr, x_te, y_te = make_image_dataset("cifar", seed=0)
    parts = dirichlet_partition(y_tr, U_MAIN, alpha=0.5, seed=0)
    cx, cy, counts = stack_clients(x_tr, y_tr, parts)
    model = make_vgg(11, width_scale=1.0)
    R = ROUNDS_MAIN
    # the Fig.-3 regime of benchmarks/fig3_cifar.py: T/m ~ 0.85 L, slow decay
    cfg = AnalysisConfig.default(U=U_MAIN, L=model.L, R=R,
                                 T_max=R * model.L * 0.85, eta0=0.05,
                                 eta_decay=0.02, seed=0)
    t0 = time.perf_counter()
    schedule = solve(cfg, "adam", steps=800, device="cuda")
    print(f"[vgg11] solve(adam, 800 steps) {time.perf_counter() - t0:.3f} s "
          f"m={schedule.m:.4f} T={[round(float(v), 4) for v in schedule.T]} "
          f"S_max={int(schedule.batch_sizes(cfg).max())}", flush=True)
    policy = make_policy("adel", cfg, schedule=schedule, device="cuda")
    launches = {}
    for comp, kernel in ((None, adel_agg), ("int8", adel_agg_q8)):
        stamps = []

        def on_round(t, params, hist):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

        adel_agg.launches = 0
        adel_agg_q8.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, hist = run_federated(model, policy, cfg, cx, cy, counts, x_te, y_te,
                                seed=0, eval_every=R - 1, compression=comp,
                                on_round=on_round, device="cuda")
        n_agg, n_q8 = adel_agg.launches, adel_agg_q8.launches
        wall = [1e3 * (b - a) for a, b in zip([t0] + stamps[:-1], stamps)]
        rounds = len(stamps)
        name = "none" if comp is None else comp
        print(f"[vgg11 {name}] rounds={rounds} per_round_wall_ms="
              f"{[round(w, 3) for w in wall]} (rounds {hist.rounds} include "
              f"eval) acc={hist.accuracy} loss={hist.train_loss} "
              f"launches adel_agg={n_agg} adel_agg_q8={n_q8}", flush=True)
        check(rounds >= 2, "VGG-11 run executed fewer than 2 rounds")
        check(all(math.isfinite(v) for v in hist.accuracy + hist.train_loss),
              "VGG-11 loss or accuracy not finite")
        own, other = (n_agg, n_q8) if comp is None else (n_q8, n_agg)
        check(own == 38 * rounds,
              f"{kernel.__name__} launched {own} times, not 38 x {rounds}")
        check(other == 0, "the other fold kernel ran in this path")
        launches[kernel.__name__] = own
    profile_rounds(torch, model, policy, cfg, (cx, cy, counts, x_te, y_te))
    return launches


def profile_rounds(torch, model, policy, cfg, data) -> None:
    """Where a steady-state round's time goes: ``torch.profiler`` over the
    rounds between the first and the last (which evaluate), uncompressed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.fl.server import run_federated

    R = cfg.R
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    window = {}

    def on_round(t, params, hist):
        torch.cuda.synchronize()
        if t == 0:
            prof.start()
            window["t0"] = time.perf_counter()
        elif t == R - 2:
            window["t1"] = time.perf_counter()
            prof.stop()

    run_federated(model, policy, cfg, *data, seed=0, eval_every=R - 1,
                  on_round=on_round, device="cuda")
    wall_ms = 1e3 * (window["t1"] - window["t0"])
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    fold_ms = sum(e.self_device_time_total for e in kernels
                  if "fold_kernel" in e.key) / 1e3
    n = R - 2
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    print(f"[vgg11 profile] rounds 2..{R - 1} ({n}): wall_ms_per_round="
          f"{wall_ms / n:.3f} device_busy_ms_per_round={busy_ms / n:.3f} "
          f"idle_share={1 - busy_ms / wall_ms:.4f} fold_kernel_ms_per_round="
          f"{fold_ms / n:.4f} fold_share_of_busy={fold_ms / busy_ms:.4f}",
          flush=True)
    for e in top:
        print(f"[vgg11 profile]   {e.self_device_time_total / 1e3 / n:9.4f} "
              f"ms/round x{e.count // n:<4d} {e.key[:90]}", flush=True)
    check(busy_ms > 0, "the profiler saw no device time")


def mlp_quickstart(torch) -> float:
    from repro_torch.core.baselines import make_policy
    from repro_torch.core.scheduler import solve
    from repro_torch.core.types import AnalysisConfig
    from repro_torch.data.synthetic import make_image_dataset
    from repro_torch.fl.partition import dirichlet_partition, stack_clients
    from repro_torch.fl.server import run_federated
    from repro_torch.models.paper_models import make_mlp

    x_tr, y_tr, x_te, y_te = make_image_dataset(
        "mnist", n_train=2500, n_test=800, seed=0, noise_std=1.0)
    parts = dirichlet_partition(y_tr, 10, alpha=0.5, seed=0)
    cx, cy, counts = stack_clients(x_tr, y_tr, parts)
    model = make_mlp()
    R = 25
    cfg = AnalysisConfig.default(U=10, L=model.L, R=R, T_max=R * model.L * 0.5,
                                 eta0=2.0, seed=0)
    schedule = solve(cfg, "adam", steps=800, device="cuda")
    policy = make_policy("adel", cfg, schedule=schedule, device="cuda")
    t0 = time.perf_counter()
    _, hist = run_federated(model, policy, cfg, cx, cy, counts, x_te, y_te,
                            seed=0, eval_every=5, device="cuda")
    torch.cuda.synchronize()
    print(f"[mlp quickstart] R={R} rounds={hist.rounds[-1]} sim_time="
          f"{hist.times[-1]:.3f} acc={hist.accuracy} wall_s="
          f"{time.perf_counter() - t0:.3f}", flush=True)
    check(hist.accuracy[-1] > 0.3, f"MLP accuracy {hist.accuracy[-1]} <= 0.3")
    check(hist.times[-1] <= cfg.T_max * 1.001, "simulated clock over T_max")
    return hist.accuracy[-1]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc" / "adel_agg.cu").is_file():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[card] {card}", flush=True)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)

    from repro_torch.kernels import build
    t0 = time.perf_counter()
    lib = build.build("adel_agg")
    print(f"[build] adel_agg.cu -> {lib.relative_to(ROOT)} in "
          f"{time.perf_counter() - t0:.3f} s (nvcc {' '.join(build.NVCC_FLAGS)})",
          flush=True)

    leaf_F = vgg_leaf_features()
    rows = kernel_cases(torch, leaf_F)
    per_round = fold_round(torch, leaf_F)
    launches = vgg_runs(torch)
    mlp_quickstart(torch)

    replaces = {"adel_agg": "src/repro/kernels/adel_agg.py:34",
                "adel_agg_q8": "src/repro/kernels/adel_agg.py:76"}
    kernels = []
    for name in ("adel_agg", "adel_agg_q8"):
        rnd = per_round[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/adel_agg.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": max([rnd["max_abs_err"]] + [
                r["max_abs_err"] for r in rows if r["kernel"] == name]),
            "ms": rnd["ms"], "plain_ms": rnd["plain_ms"],
            "bound_ms": rnd["bound_ms"], "bound_by": "bytes",
            "library_ms": rnd["library_ms"],
            "shapes": "one round's fold: 38 VGG-11 leaves at U=10, "
                      + ("f32" if name == "adel_agg" else "int8"),
            "card": card})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
