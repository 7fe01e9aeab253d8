#!/usr/bin/env python3
"""Does ``torch.profiler`` record every kernel launch on the card?

    python3 scripts/probe_profiler.py [--reps 12] [--synthetic 30]
        [--ways plain,spun]

``KINETO_LOG_LEVEL=0`` in the environment also prints the profiler's own
record counts (its "Out-of-range" count is the records it dropped).

Repeats one deterministic workload under many profile sessions in one
process and counts the device kernels each session records: a session that
records fewer kernels than the others lost some. Two workloads:

* ``synthetic``: 4,000 one-element adds with a grouped fold launch
  (``adel_agg_grouped``) after every 1,000, so the position of a lost fold
  is known;
* ``grad`` (``--grad``): one ``torch.func.grad`` call through the bf16
  ``FlashAttention`` at hymba-1.5b's training block shape (one flash
  launch and its plain backward);
* ``fleet``: the ``[vgg11 fleet]`` phase of ``chip_smoke.py`` at 10,000
  devices (solve, 3 hierarchical rounds over 4 regions, evaluation).

Ways of profiling (``--ways`` picks those run, in turns): ``plain`` (one
``with profile(...)`` around the work, as ``chip_smoke.py``'s launch counts
did), ``slept`` (the same with the card idle for ``MARGIN_S`` on each side
of the work), ``guarded`` (``slept`` with 1,000 adds and a synchronize
between the first idle stretch and the work), ``warmed`` (a schedule that
records the second of two steps, the first a short burst of adds),
``padded`` (one window: 1,000 adds, the work, 1,000 adds, each followed by
a synchronize) and ``spun`` (200 short spin kernels, then one of ~10 ms,
unsynchronized, so the card is busy from the window's start into the work;
idle for ``MARGIN_S`` before the window closes; spin kernels are left out
of the counts). A ``+cpu`` suffix adds host activity. Prints one line a
session (kernels, folds, kernels in each stretch between folds; for the
fleet also where its first stretch differs from the way's first session)
and a summary: the sessions whose count differs from the most common one,
by way.
"""
from __future__ import annotations

import argparse
import collections
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def kernel_events(prof):
    """The profile's device events, less the ``spun`` way's spin kernels."""
    from torch.autograd import DeviceType
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and "spin_kernel" not in e.name]


def spins(prof) -> int:
    from torch.autograd import DeviceType
    return sum(e.device_type == DeviceType.CUDA and "spin_kernel" in e.name
               for e in prof.events())


def profiled(torch, way: str, work):
    """Profile ``work()`` one way; returns (profile, what work returned)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    acts = [ProfilerActivity.CUDA]
    if way.endswith("+cpu"):
        way, acts = way[:-4], acts + [ProfilerActivity.CPU]
    if way == "plain":
        with profile(activities=acts) as prof:
            out = work()
            torch.cuda.synchronize()
        return prof, out
    x = torch.zeros(1, device="cuda")
    if way == "spun":
        with profile(activities=acts) as prof:
            for _ in range(SPIN_BURST):
                torch.cuda._sleep(SPIN_SHORT)
            torch.cuda._sleep(SPIN_LONG)
            out = work()
            torch.cuda.synchronize()
            time.sleep(MARGIN_S)
        return prof, out
    if way in ("slept", "guarded"):
        with profile(activities=acts) as prof:
            torch.cuda.synchronize()
            time.sleep(MARGIN_S)
            if way == "guarded":
                for _ in range(PAD):
                    x.add_(1)
                torch.cuda.synchronize()
            out = work()
            torch.cuda.synchronize()
            time.sleep(MARGIN_S)
        return prof, out
    if way == "padded":
        with profile(activities=acts) as prof:
            for _ in range(PAD):
                x.add_(1)
            torch.cuda.synchronize()
            out = work()
            torch.cuda.synchronize()
            for _ in range(PAD):
                x.add_(1)
            torch.cuda.synchronize()
        return prof, out
    with profile(activities=acts, schedule=schedule(
            wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(64):
            x.add_(1)
        torch.cuda.synchronize()
        prof.step()
        out = work()
        torch.cuda.synchronize()
        prof.step()
    return prof, out


PAD = 1000
MARGIN_S = 0.5
SPIN_BURST, SPIN_SHORT, SPIN_LONG = 200, 1_000, 20_000_000
WAYS = ("plain", "slept", "guarded", "warmed", "padded", "spun",
        "slept+cpu")


def synthetic(torch):
    from repro_torch.kernels.adel_agg import adel_agg_grouped
    g = torch.Generator(device="cuda").manual_seed(0)
    leaves = [torch.randn(4, 3, 4096, device="cuda", generator=g)]
    ids = [torch.arange(3, device="cuda")]
    coeff = torch.rand(4, 3, device="cuda", generator=g)
    x = torch.zeros(1, device="cuda")

    def work():
        for _ in range(4):
            for _ in range(1000):
                x.add_(1)
            adel_agg_grouped(leaves, ids, coeff)
        return None
    return work


def grad_work(torch):
    """One ``torch.func.grad`` call through ``FlashAttention`` (bf16) at
    hymba-1.5b's training block shape, as ``chip_smoke.py``'s ``[lm grad]``
    times it: 8 rows of 256 tokens, 25 / 5 heads of 64, window 1024."""
    from repro_torch.kernels.ops import gqa_flash
    g = torch.Generator(device="cuda").manual_seed(5)
    B, S, H, KV, hd = 8, 256, 25, 5, 64
    w = torch.randn((B, S, H, hd), generator=g, device="cuda")
    args = tuple(torch.randn((B, S, h, hd), generator=g,
                             device="cuda").to(torch.bfloat16)
                 for h in (H, KV, KV))

    def loss(q, k, v):
        y = gqa_flash(q, k, v, causal=True, window=1024).float()
        return (y * w).sum() + 0.5 * (y * y).sum()

    fn = torch.func.grad(loss, argnums=(0, 1, 2))
    return lambda: fn(*args)


def count(prof) -> tuple[int, int, list, list]:
    """(kernels, folds, kernels in each stretch between folds, the names of
    the first stretch's kernels in order): the pad bursts of the ``padded``
    and ``guarded`` ways are in the first and last stretch."""
    ev = sorted(kernel_events(prof), key=lambda e: e.time_range.start)
    segs, n, first = [], 0, None
    for e in ev:
        if "fold_grouped_kernel" in e.name:
            if first is None:
                first = [f.name for f in ev[:n]]
            segs.append(n)
            n = 0
        else:
            n += 1
    segs.append(n)
    return len(ev), len(segs) - 1, segs, first or []


def where_lost(ref: list, got: list) -> str:
    """Where ``got`` falls short of ``ref``: the common prefix and suffix
    lengths and the names in ``ref`` between them (when few)."""
    p = 0
    while p < min(len(ref), len(got)) and ref[p] == got[p]:
        p += 1
    s = 0
    while (s < min(len(ref), len(got)) - p
           and ref[len(ref) - 1 - s] == got[len(got) - 1 - s]):
        s += 1
    gap = ref[p:len(ref) - s]
    names = collections.Counter(n[:40] for n in gap).most_common(4)
    return f"prefix={p} suffix={s} of {len(ref)} gap={len(gap)} {names}"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=12)
    ap.add_argument("--synthetic", type=int, default=30)
    ap.add_argument("--grad", type=int, default=0)
    ap.add_argument("--ways", default="plain,spun")
    args = ap.parse_args()
    ways = args.ways.split(",")
    assert set(ways) <= set(WAYS), ways
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[card] {cs.card_line()}", flush=True)
    build.build_all()
    seen = collections.defaultdict(list)

    from repro_torch.kernels.flash_attention import flash_attention
    work = grad_work(torch)
    work()
    for i in range(args.grad):
        way = ways[i % len(ways)]
        print(f"[session] grad {i} {way}", file=sys.stderr, flush=True)
        before = flash_attention.launches
        prof, _ = profiled(torch, way, work)
        ev = sorted(kernel_events(prof), key=lambda e: e.time_range.start)
        t0 = ev[0].time_range.start if ev else 0
        flash = [round(e.time_range.start - t0, 1) for e in ev
                 if "flash_fwd_kernel" in e.name]
        seen[("grad", way)].append(len(ev))
        print(f"[grad] {i:3d} {way:9s} kernels={len(ev)} spins={spins(prof)} "
              f"flash_at_us={flash} "
              f"launches={flash_attention.launches - before} first="
              f"{[e.name[:30] for e in ev[:3]]}", flush=True)

    work = synthetic(torch)
    work()
    for i in range(args.synthetic):
        way = ways[i % len(ways)]
        print(f"[session] synthetic {i} {way}", file=sys.stderr, flush=True)
        prof, _ = profiled(torch, way, work)
        n, folds, at, _ = count(prof)
        seen[("synthetic", way)].append(n)
        print(f"[synthetic] {i:3d} {way:6s} kernels={n} spins={spins(prof)} "
              f"folds={folds} "
              f"between_folds={at}", flush=True)

    from repro_torch import obs
    from repro_torch.fl.spec import ExecSpec
    from repro_torch.fleet import make_population, partition_fleet, run_fleet
    vgg = cs.vgg_setup(torch)
    data = partition_fleet(*vgg["raw"], cs.FLEET_SHARDS, alpha=0.5, seed=0)
    counters = cs.fold_counters()
    kw = dict(availability="bernoulli", availability_kwargs=(("rate", 0.7),),
              regions=cs.FLEET_REGIONS)
    model = vgg["model"]

    def fleet():
        pop = make_population("parametric:longtail-mobile", size=10_000, **kw)
        _, hist = run_fleet(
            model, pop, data=data, rounds=cs.FLEET_ROUNDS,
            cohort_size=cs.FLEET_COHORT,
            exec=ExecSpec(backend="hierarchical", regions=cs.FLEET_REGIONS),
            T_max=cs.FLEET_ROUNDS * model.L * 0.85, eta0=0.05,
            eta_decay=0.02, solver_steps=300, seed=0,
            tracer=obs.Tracer(obs.MemorySink()), device="cuda")
        return hist

    refs: dict = {}
    for i in range(args.reps):
        way = ways[i % len(ways)]
        for k in counters.values():
            k.launches = 0
        t0 = time.perf_counter()
        print(f"[session] fleet {i} {way}", file=sys.stderr, flush=True)
        prof, hist = profiled(torch, way, fleet)
        n, folds, at, first = count(prof)
        ref = refs.setdefault(way, first)
        fired = counters["adel_agg_grouped"].launches
        seen[("fleet", way)].append(n)
        print(f"[fleet] {i:3d} {way:6s} kernels={n} spins={spins(prof)} "
              f"folds={folds} "
              f"wrapper_folds={fired} between_folds={at} loss={hist.train_loss} "
              f"wall_s={time.perf_counter() - t0:.3f}", flush=True)
        print(f"[fleet] {i:3d} first stretch against session "
              f"{way} 0: {where_lost(ref, first)}", flush=True)

    for (what, way), ns in sorted(seen.items()):
        mode = collections.Counter(ns).most_common(1)[0][0]
        odd = {i: n for i, n in enumerate(ns) if n != mode}
        print(f"[summary] {what} {way}: sessions={len(ns)} kernels={mode} "
              f"differing={odd}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
