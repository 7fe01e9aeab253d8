#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit), the torch and
   CUDA versions, and both TF32 flags (set False: f32 means f32).
2. Builds the CUDA kernels from ``src/repro_torch/csrc`` with ``nvcc``, one
   process per source, all started together.
3. Holds each fold kernel against its plain PyTorch version on the card at
   the FL path's shapes (every VGG-11 leaf at U=10), a stacked and a ragged
   case, and for ``adel_agg_q8`` a zero-coefficient row and a zero-scale
   layer; times kernel, plain version and one ``torch.einsum`` (a yardstick
   the port never calls) as CUDA-graph replays, the kernel also as eager
   calls, and computes the bandwidth bound. The grouped folds
   (``adel_agg_grouped`` in f32 and bf16, ``adel_agg_q8_grouped`` in int8)
   also fold a table of 70 leaves (stacked and scalar layer ids, ragged F)
   in two launches. Then one round's fold: all 38 VGG-11 leaves, f32 in one
   grouped launch and int8 in one grouped launch, each against its plain
   version, timed the same way beside the 38 ``torch.einsum`` calls (f32)
   and the 38 per-leaf ``adel_agg_q8`` launches of earlier rounds (int8).
4. Holds the LM kernels against their plain versions the same way:
   ``flash_attention`` (both on the tensor cores: bf16, and f32 as 3xTF32) at
   hymba-1.5b's prefill shape and its training block (8 x 256 tokens), at
   yi-6b's, with a ragged S, non-causal with
   Sq != Sk and with rows that see no key, each in bf16 and f32, and
   through ``gqa_flash`` on the model's (B, S, H, hd) tensors at hymba's
   shape, beside ``scaled_dot_product_attention`` (a yardstick the port
   never calls); ``ssd_scan`` (one pass over the chunks, 3xTF32 on the
   tensor cores) at hymba-1.5b's and mamba2-370m's shapes, and at hymba's
   prefill and training block read through strides from the model's (B, S,
   H, P) layout, two calls bit for bit, with the kernel's device time.
   Bound: the larger of bytes over HBM rate and flops over the dtype's
   peak (f32 flash and the SSD scan: three TF32 products a product, 495 / 3
   TFLOP/s, with the CUDA cores' 67 TFLOP/s bound beside it). Prints
   ptxas's registers and spills of every kernel, the flash library's count
   of ``HGMMA`` (tf32 and bf16 apart; fails without tf32 ones) and
   ``UTMALDG`` instructions, and the SSD library's tf32 ``HGMMA`` s (fails
   without them).
5. Drives the FL path at full width: ``run_federated`` on VGG-11
   (``width_scale=1.0``), synthetic CIFAR, U=10 Dirichlet(0.5) clients, the
   ADEL policy from ``solve(cfg, "adam")``, once uncompressed and once with
   int8 payloads: one grouped fold launch a round each
   (``adel_agg_grouped``, ``adel_agg_q8_grouped``). Two more runs, one of
   each, are profiled: device busy and idle time per round, the fold
   kernel's share, the top device kernels.
6. The same cell through the other execution backends (``ExecSpec``):
   the grouped folds at the widths they hand them (one client, a chunk of
   4, a region of 5) against their plain versions; chunked
   (``chunk_size=4``: 12 padded clients in 3 chunks), temporal and
   hierarchical (``regions=2``), uncompressed and int8, 3 rounds each:
   wall a round, the fold launches a round counted by ``torch.profiler``
   (3 / 10 / 2 grouped launches, no other fold launch), and one round from
   the same params, batches and mask within 1e-4 of the dense update;
   HeteroFL on dense and chunked (finite losses, no fold launch: the
   width-overlap mean is plain PyTorch, as in the reference; chunked
   within 1e-4 of dense); and a dense round's host time by phase from the
   tracer (rounds 2-4), against the traced and the untraced wall a round,
   with the aggregate phase split into compress, fold and update by this
   script's own synchronized timers.
7. The shard_map backend on ``torch.distributed``: over a one-rank NCCL
   group in this process (one round bit-identical to dense, checked to
   1e-4 of the update; one grouped fold launch a round and no other fold
   launch by ``torch.profiler``; the NCCL kernels it counts; wall a
   round), and over 2 ranks spawned on ``cuda:0`` joined by gloo (each
   trains 5 of the 10 clients; both exit codes checked; each rank's round
   within 1e-4 of this process's dense update; one grouped fold launch a
   rank a round), uncompressed and int8. Then the prefetch round loop
   against serial on dense (none, int8) and on shard_map over the NCCL
   rank, 5 rounds evaluating every round: History equal and params
   bit-equal under ``cudnn.deterministic``, wall a steady round in turns,
   the device-idle share, and the pipeline counters of a traced run.
8. The buffered backend on the VGG-11 cell (``lam=0.5``, ``max_age=4``,
   ``buffer_cap=4``, 5 rounds), uncompressed and int8: ``lam=0``
   bit-identical to dense; with ``lam>0`` one grouped fold launch a round
   plus one a carry slot folded that round (wrappers a round, and
   ``torch.profiler``), no other fold launch; each carried slot's fold
   against the plain fold of its banked payload; a round's carry counts,
   wall and peak memory; and prefetch against serial on it (bit-identical).
   Then ``run_fleet`` at full VGG-11 width on a parametric
   ``longtail-mobile`` population of 10,000 and of 1,000,000 devices
   (Bernoulli 0.7, cohort 16, hierarchical over 4 edge regions from the
   device ids, 3 rounds): one grouped fold launch a non-empty region a
   round, finite losses, the ``cohort`` span's host ms at both sizes. Then
   three registry scenarios at their published size and rounds
   (``longtail-mobile-buffered``, ``longtail-mobile-diurnal-replan``,
   ``longtail-mobile-diurnal-int8``): rounds run and skipped, replan
   events, carried totals, final accuracy, the replan run's deadlines
   within ``T_max``.
9. Runs the quickstart regime (MLP, R=25) on the card: accuracy > 0.3.
10. Drives the LM path at full width: ``make_prefill_step`` on hymba-1.5b
   (all 32 blocks, bf16) over 2 x 4096 random tokens, with 32 launches of
   each LM kernel per prefill (an ``ssd_scan`` launch is one kernel) and
   finite (2, 32256) logits, then profiled (flash and SSD device time,
   layout copies);
   ``serve("hymba-1.5b", reduced=False)`` (batch 4, 64 + 32 tokens); and the
   prefill (kernels) against stepping the decode path (plain) over 1152
   tokens, past the 1024 window, at full width cut to 4 blocks in f32.
11. Trains the LM on the card. Each LM kernel's ``autograd.Function``
   (``FlashAttention`` in bf16 and f32, ``SSDScan`` in f32) at hymba-1.5b's
   training block shape (8 rows of 256 tokens, the model's layout read
   through strides): ``torch.func.grad`` of a loss through it against the
   same loss through the plain version, once and under ``torch.func.vmap``
   over 4 clients, one kernel launch a call either way. Then
   ``run_training("hymba-1.5b", reduced=False, backend="temporal")``: all 32
   blocks, f32 params, bf16 compute, U=4, 256-token rows, at most 8 a
   client, 3 rounds, ADEL from ``solve(cfg, "adam", steps=600)``: finite
   losses, changed params, wall a round, peak memory, the launches a round
   (32 flash and 32 SSD scans a client forward and an eval forward, one
   grouped fold a client, no other fold), and round 2 under
   ``torch.profiler`` (device activity): the device time split into the
   forward kernels, GEMMs, the log-softmax, the fold and the rest, and the
   idle share; the plain backwards' device ms a round from the gradient
   cases (a block's grad call less its kernel, device time by
   ``torch.profiler``). Then dense against temporal at full width cut to
   4 blocks in f32, one round each, uncompressed and int8: updates within
   1e-4 of the update's max (int8: one code step, 1/127), one
   ``adel_agg_grouped`` / ``adel_agg_q8_grouped`` launch a round on dense and
   one a client on temporal, on the LM's stacked leaves.
12. MoE and MLA. ``flash_attention`` at arctic-480b's GQA (56 q heads over
   8 KV heads of 128, G = 7, B 2, S 4096, causal, bf16) is among step 4's
   cases. deepseek-v2-lite-16b at full width and depth (27 blocks, 64
   routed experts top-6, 2 shared, MLA kv_lora 512; bf16 params drawn on the
   card): ``make_prefill_step`` over 2 x 4096 tokens (finite logits, no LM
   kernel launched: MLA prefill is plain, as in the reference), tokens/s,
   peak memory, and one prefill under ``torch.profiler`` with host stacks:
   idle share and device ms by kind (expert GEMMs, dispatch/combine index
   ops, router, MLA attention, other GEMMs, the rest); then greedy serving
   through ``make_serve_step`` (batch 4, 64 + 32 tokens, f32 latent cache):
   decode tokens/s. arctic-480b at full width cut to 2 of 35 blocks (bf16,
   55.4 GB): the same prefill, with 2 flash launches by the wrapper and by
   the profiler. ``[moe agree]``: the prefill at ``capacity_factor =
   n_experts`` against stepping the dropless decode path over 2 x 64
   tokens, arctic at 2 blocks in bf16 and deepseek at 2 blocks in f32.
   ``[moe train]``: ``run_training("deepseek-v2-lite-16b", reduced=False,
   layers=2)`` (1.59 B f32 params), temporal, U=4, 256-token rows, at most
   8 a client, 3 rounds: finite losses, every leaf changed, one grouped fold
   launch a client a round and no other kernel (wrappers and
   ``torch.profiler``), wall a round, peak memory, idle share; and one
   client's fold on these leaves (the (L, E*D*F) expert leaves among them)
   against its plain version, beside 18 ``torch.einsum`` calls.
13. Encoder-decoder and vision-prefix LMs, remat, calibration.
   ``flash_attention`` at seamless-m4t-medium's encoder (non-causal, 1024
   over 1024, 16/16 heads of 64), its decoder's causal self-attention (4096
   over 4096), its cross-attention (4096 over 1024), the training step's
   self- and cross-attention (256 over 256 causal, 256 over 1024), and
   llava-next-34b's GQA (56/8 heads of 128, S 3904: a ragged last q tile)
   is among step 4's cases, bf16 and f32. ``[seamless prefill]``: the
   whole model (12 + 12 blocks, bf16) over 2 x (1024 frames + 4096 text
   tokens) through ``make_prefill_step(cfg)(params, tokens, frames)``: 36
   flash launches by the wrapper and the profiler, 12 at each of the
   encoder's, self- and cross-attention's problems by the wrapper's tally,
   tokens/s over every position and over the text, peak memory, idle share
   and device ms by kind. ``[seamless serve]`` (``serve``, batch 4, 64 + 32
   tokens, the encoder and the cross cache first), ``[encdec agree]`` (2 +
   2 blocks, f32: the prefill through the kernel against stepping the
   decode path with a cross cache from an encoder run with the plain
   attention), ``[seamless train]`` (one temporal ``make_train_step``
   round, U=2, frames: every leaf changed, one grouped fold a client, 36
   flash launches a client forward and 36 in its backward's recompute, 48
   at each problem in the round). ``[llava prefill]``: the whole model (60 blocks,
   bf16, 68.8 GB) over 2 x (2880 patches + 1024 text tokens): 60 flash
   launches, init seconds and peak; ``[llava agree]`` (2 blocks, bf16:
   every position against the plain attention on the card). ``[remat]``:
   one hymba-1.5b client's step (8 x 256 tokens), spatial and temporal,
   with and without ``remat``: the updates compared, each one's wall and
   peak memory. ``[calibrate]``:
   ``calibrate_constants`` on the card against the CPU (MLP), then VGG-11.
14. Prints the ``kernels`` JSON line and, last, the ``{"ok": true, ...}``
    line.

Exits non-zero, printing no result, without a CUDA device or without the
repository's ``src/repro_torch`` beside it; any failed phase exits non-zero.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12       # H100 SXM bf16 tensor cores, dense
TF32_FLOPS_PER_S = 495e12       # H100 SXM TF32 tensor cores, dense
# the f32 flash kernel and the SSD scan take each product as three TF32
# products (3xTF32)
F32_FLASH_FLOPS_PER_S = TF32_FLOPS_PER_S / 3
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


# torch.profiler drops device records ("Out-of-range") at both edges of
# its window on the H100 (scripts/probe_profiler.py): the first kernels
# of a window (1 to 30, more as the process ages) and, when it stops right
# after the work, the last ones (up to ~800 of a fleet run's, a grouped
# fold among them). So every profile this script reads opens with
# SPIN_BURST short spin kernels and a ~10 ms one, launched without a
# synchronize so the card stays busy into the work (the losses fall on
# them), and closes after the card has been idle for PROFILE_MARGIN_S;
# ``device_kernels`` leaves the spin kernels out of every count and sum.
# In that probe's runs this way no kernel of the work was lost.
PROFILE_MARGIN_S = 0.5
SPIN_BURST, SPIN_SHORT, SPIN_LONG = 200, 1_000, 20_000_000   # cycles


def open_window(torch) -> None:
    """The spin kernels a profile's window opens with."""
    for _ in range(SPIN_BURST):
        torch.cuda._sleep(SPIN_SHORT)
    torch.cuda._sleep(SPIN_LONG)


def close_window(torch) -> None:
    """Wait for the card, then leave it idle for ``PROFILE_MARGIN_S``
    before the window closes."""
    torch.cuda.synchronize()
    time.sleep(PROFILE_MARGIN_S)


@contextlib.contextmanager
def device_profile(torch, cpu: bool = False, stack: bool = False):
    """``torch.profiler`` of the device (and the host if ``cpu``, with each
    host op's Python stack if ``stack``) over the body, the window opened
    and closed as above."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    kw = {}
    if stack:     # verbose: each host op also keeps its stack as a list
        kw = dict(with_stack=True, experimental_config=torch._C._profiler.
                  _ExperimentalConfig(verbose=True))
    with profile(activities=acts, **kw) as prof:
        open_window(torch)
        yield prof
        close_window(torch)


def device_kernels(prof) -> list:
    """A profile's device entries by kernel name, less the spin kernels its
    window opened with."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.key]


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


def bound_ms(bytes_moved: float, flops: float,
             flops_per_s: float = F32_FLOPS_PER_S) -> float:
    """Least time on the card: bytes over HBM rate or operations over the
    peak rate of their type (f32 by default), whichever is larger."""
    return 1e3 * max(bytes_moved / HBM_BYTES_PER_S, flops / flops_per_s)


def bound_by(bytes_moved: float, flops: float,
             flops_per_s: float = F32_FLOPS_PER_S) -> str:
    return ("bytes" if bytes_moved / HBM_BYTES_PER_S >= flops / flops_per_s
            else "operations")


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

    # the grouped folds: 70 leaves, two launches; stacked ids on the host
    # (a range) and on the card, scalar ids, ragged F
    from repro_torch.kernels.adel_agg import (
        adel_agg_grouped, adel_agg_grouped_plain, adel_agg_q8_grouped,
        adel_agg_q8_grouped_plain, table_leaves)
    L = 40
    spec = [(1 + k % 3, [300, 7, 4096, 1000, 8, 2048][k % 6]) for k in range(70)]
    for dtype, tdt in (("f32", torch.float32), ("bf16", torch.bfloat16),
                       ("q8", torch.int8)):
        g32 = [randn(U_MAIN, rows, F) for rows, F in spec]
        ids = [k % L if rows == 1 else
               (torch.arange(k % 7, k % 7 + rows) if k % 2 else
                torch.randperm(L, generator=gen, device="cuda")[:rows])
               for k, (rows, F) in enumerate(spec)]
        c = rand(U_MAIN, L)
        # the plain version gathers coefficient rows with the ids on the
        # card, so that it can be captured in a CUDA graph
        ids_dev = [i if isinstance(i, int) else i.to("cuda") for i in ids]
        if dtype == "q8":
            g32[0][:, 0] = 0.0          # a zero-scale row folds to exactly 0
            qs, ss = map(list, zip(*(quantize(torch, g) for g in g32)))
            entry, leaves = adel_agg_q8_grouped, qs
            kern = (lambda: adel_agg_q8_grouped(qs, ss, ids, c))
            plain = (lambda: adel_agg_q8_grouped_plain(qs, ss, ids_dev, c))
            nbytes = sum(q8_bytes(U_MAIN, q.shape[1], q.shape[2]) for q in qs)
        else:
            leaves = [g.to(tdt) for g in g32]
            entry = adel_agg_grouped
            kern = (lambda: adel_agg_grouped(leaves, ids, c))
            plain = (lambda: adel_agg_grouped_plain(leaves, ids_dev, c))
            nbytes = sum(agg_bytes(U_MAIN, x.shape[1], x.shape[2],
                                   x.element_size()) for x in leaves)
        before = entry.launches
        outs = kern()
        n_launch = entry.launches - before
        check(n_launch == -(-70 // table_leaves(leaves[0].element_size())),
              f"the 70-leaf table took {n_launch} {entry.__name__} launches")
        refs = plain()
        n_el = sum(x.numel() for x in leaves)
        rtol, atol = TOL[dtype]
        err = max(float((o.float() - r.float()).abs().max())
                  for o, r in zip(outs, refs))
        ok = all(bool(((o.float() - r.float()).abs()
                       <= atol + rtol * r.float().abs()).all())
                 for o, r in zip(outs, refs))
        row = {"kernel": "adel_agg_q8" if dtype == "q8" else "adel_agg",
               "case": "table70", "dtype": dtype,
               "U": U_MAIN, "L": L, "F": n_el // U_MAIN,
               "max_abs_err": err, "rtol": rtol, "atol": atol, "ok": ok,
               "kernel_ms": graph_ms(torch, kern),
               "call_ms": call_ms(torch, kern),
               "plain_ms": graph_ms(torch, plain),
               "library_ms": None,
               "bound_ms": bound_ms(nbytes, 2 * n_el)}
        print(f"[kernel] {entry.__name__} table70 {dtype:4s} leaves=70 "
              f"launches={n_launch} max_abs_err={err:.3e} tol=rtol {rtol:g}/atol "
              f"{atol:g} kernel_ms={row['kernel_ms']:.5f} call_ms="
              f"{row['call_ms']:.5f} plain_ms={row['plain_ms']:.5f} "
              f"bound_ms={row['bound_ms']:.5f} {'ok' if ok else 'FAIL'}",
              flush=True)
        check(ok, f"{entry.__name__} 70-leaf table {dtype} disagrees: {err}")
        check(dtype != "q8" or bool((outs[0][0] == 0).all()),
              "a zero-scale row of the grouped int8 fold is not exactly 0")
        rows.append(row)

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
    """One round's fold on the main path: all 38 VGG-11 leaves at U=10, as
    the runtime issues them: f32 in one ``adel_agg_grouped`` launch and
    int8 in one ``adel_agg_q8_grouped`` launch, each leaf's weights read
    from the (U, 38) coefficients through its layer id. Timed as one CUDA
    graph (the f32 inputs, 390 MB, do not fit in the 50 MB L2; the int8
    ones, 98 MB, neither) beside the plain versions, the 38 ``torch.einsum``
    calls (f32) and the 38 per-leaf ``adel_agg_q8`` launches that folded an
    int8 round before the grouped entry (``adel_agg_q8 per-leaf``)."""
    from repro_torch.kernels.adel_agg import (adel_agg_grouped,
                                              adel_agg_grouped_plain,
                                              adel_agg_q8, adel_agg_q8_grouped,
                                              adel_agg_q8_grouped_plain,
                                              adel_agg_q8_plain)
    gen = torch.Generator(device="cuda").manual_seed(1)
    sizes = [F for F, n in leaf_F.items() for _ in range(n)]
    coeff = torch.rand((U_MAIN, len(sizes)), generator=gen, device="cuda")
    ids = list(range(len(sizes)))
    leaves = []
    for k, F in enumerate(sizes):
        g = torch.randn((U_MAIN, 1, F), generator=gen, device="cuda")
        leaves.append((g, coeff[:, k:k + 1].contiguous()) + quantize(torch, g))
    grads = [a[0] for a in leaves]
    qs, ss = [a[2] for a in leaves], [a[3] for a in leaves]
    n_el = sum(g.numel() for g in grads)
    F_tot = n_el // U_MAIN
    for entry, fold in ((adel_agg_grouped,
                         lambda: adel_agg_grouped(grads, ids, coeff)),
                        (adel_agg_q8_grouped,
                         lambda: adel_agg_q8_grouped(qs, ss, ids, coeff))):
        before = entry.launches
        fold()
        check(entry.launches - before == 1,
              f"the 38 VGG-11 leaves did not fold in one {entry.__name__} "
              "launch")
    q8_round_bytes = sum(q8_bytes(U_MAIN, 1, g.shape[2]) for g in grads)
    fns = {
        "adel_agg": (
            "1 grouped launch",
            lambda: adel_agg_grouped(grads, ids, coeff),
            lambda: adel_agg_grouped_plain(grads, ids, coeff),
            lambda: [torch.einsum("ul,ulf->lf", c, g) for g, c, *_ in leaves],
            sum(agg_bytes(U_MAIN, 1, g.shape[2], 4) for g in grads),
            list(zip(adel_agg_grouped(grads, ids, coeff),
                     adel_agg_grouped_plain(grads, ids, coeff)))),
        "adel_agg_q8": (
            "1 grouped launch",
            lambda: adel_agg_q8_grouped(qs, ss, ids, coeff),
            lambda: adel_agg_q8_grouped_plain(qs, ss, ids, coeff),
            None, q8_round_bytes,
            list(zip(adel_agg_q8_grouped(qs, ss, ids, coeff),
                     adel_agg_q8_grouped_plain(qs, ss, ids, coeff)))),
        "adel_agg_q8 per-leaf": (
            "38 launches",
            lambda: [adel_agg_q8(q, s, c) for g, c, q, s in leaves],
            lambda: [adel_agg_q8_plain(q, s, c) for g, c, q, s in leaves],
            None, q8_round_bytes,
            [(adel_agg_q8(q, s, c), adel_agg_q8_plain(q, s, c))
             for g, c, q, s in leaves]),
    }
    out = {}
    for name, (launches, kern, plain, lib, nbytes, pairs) in fns.items():
        err = max(float((o - r).abs().max()) for o, r in pairs)
        rnd = {"ms": graph_ms(torch, kern, reps=3),
               "call_ms": call_ms(torch, kern, iters=5, warmup=2),
               "plain_ms": graph_ms(torch, plain, reps=3),
               "library_ms": None if lib is None else graph_ms(torch, lib,
                                                               reps=3),
               "bound_ms": bound_ms(nbytes, 2 * n_el), "max_abs_err": err,
               "bytes": nbytes}
        print(f"[fold round] {name} 38 leaves ({launches}) U={U_MAIN} "
              f"F_total={F_tot} bytes={nbytes} max_abs_err={err:.3e} "
              + " ".join(f"{k}={'null' if v is None else f'{v:.5f}'}"
                         for k, v in rnd.items()
                         if k.endswith("ms")), flush=True)
        check(err <= 1e-5 * (1 + max(float(r.abs().max()) for _, r in pairs)),
              f"{name} round fold disagrees with its plain version: {err}")
        out[name] = rnd
    check(out["adel_agg_q8"]["ms"] < out["adel_agg_q8 per-leaf"]["ms"],
          "the grouped int8 round is not faster than its 38 launches")
    return out


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------

def vgg_setup(torch, schedule=None) -> dict:
    """The VGG-11 cell: model at full width, synthetic CIFAR split over
    U=10 Dirichlet(0.5) clients, the Fig.-3 regime's config and ADEL's
    schedule from ``solve(cfg, "adam", steps=800)`` (or the ``schedule``
    given: a spawned rank takes its parent's)."""
    from repro_torch.core.baselines import make_policy
    from repro_torch.core.scheduler import solve
    from repro_torch.core.types import AnalysisConfig
    from repro_torch.data.synthetic import make_image_dataset
    from repro_torch.fl.partition import dirichlet_partition, stack_clients
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
    if schedule is None:
        t0 = time.perf_counter()
        schedule = solve(cfg, "adam", steps=800, device="cuda")
        print(f"[vgg11] solve(adam, 800 steps) {time.perf_counter() - t0:.3f} "
              f"s m={schedule.m:.4f} "
              f"T={[round(float(v), 4) for v in schedule.T]} "
              f"S_max={int(schedule.batch_sizes(cfg).max())}", flush=True)
    policy = make_policy("adel", cfg, schedule=schedule, device="cuda")
    return {"model": model, "cfg": cfg, "policy": policy,
            "data": (cx, cy, counts, x_te, y_te),
            "raw": (x_tr, y_tr, x_te, y_te)}


def fold_counters() -> dict:
    """Each fold wrapper, by name: its ``launches`` count."""
    from repro_torch.kernels.adel_agg import (adel_agg, adel_agg_grouped,
                                              adel_agg_q8, adel_agg_q8_grouped)
    return {k.__name__: k for k in (adel_agg_grouped, adel_agg_q8_grouped,
                                    adel_agg_q8, adel_agg)}


def vgg_runs(torch, vgg: dict) -> dict:
    from repro_torch.fl.server import run_federated

    model, cfg, policy = vgg["model"], vgg["cfg"], vgg["policy"]
    cx, cy, counts, x_te, y_te = vgg["data"]
    R = cfg.R
    launches = {}
    counters = fold_counters()
    # one grouped launch folds a round's 38 leaves: f32 uncompressed, int8
    # codes compressed
    for comp, kernel in ((None, "adel_agg_grouped"),
                         ("int8", "adel_agg_q8_grouped")):
        stamps = []

        def on_round(t, params, hist):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

        for k in counters.values():
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, hist = run_federated(model, policy, cfg, cx, cy, counts, x_te, y_te,
                                seed=0, eval_every=R - 1, compression=comp,
                                on_round=on_round, device="cuda")
        fired = {k: c.launches for k, c in counters.items()}
        wall = [1e3 * (b - a) for a, b in zip([t0] + stamps[:-1], stamps)]
        rounds = len(stamps)
        name = "none" if comp is None else comp
        print(f"[vgg11 {name}] rounds={rounds} per_round_wall_ms="
              f"{[round(w, 3) for w in wall]} (rounds {hist.rounds} include "
              f"eval) acc={hist.accuracy} loss={hist.train_loss} launches "
              + " ".join(f"{k}={v}" for k, v in fired.items()), flush=True)
        check(rounds >= 2, "VGG-11 run executed fewer than 2 rounds")
        check(all(math.isfinite(v) for v in hist.accuracy + hist.train_loss),
              "VGG-11 loss or accuracy not finite")
        own = fired.pop(kernel)
        check(own == rounds,
              f"{kernel} launched {own} times, not once in each of "
              f"{rounds} rounds")
        check(not any(fired.values()),
              f"another fold kernel ran in this path: {fired}")
        launches["adel_agg" if comp is None else "adel_agg_q8"] = own
    for comp in (None, "int8"):
        profile_rounds(torch, model, policy, cfg, (cx, cy, counts, x_te, y_te),
                       comp)
    return launches


def profile_rounds(torch, model, policy, cfg, data, comp) -> None:
    """Where a steady-state round's time goes: ``torch.profiler`` over the
    rounds between the first and the last (which evaluate), with payloads
    compressed by ``comp`` (None or "int8")."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.fl.server import run_federated

    R = cfg.R
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    window = {}

    def on_round(t, params, hist):
        torch.cuda.synchronize()
        if t == 0:
            prof.start()
            open_window(torch)
            torch.cuda.synchronize()
            window["t0"] = time.perf_counter()
        elif t == R - 2:
            window["t1"] = time.perf_counter()
            close_window(torch)
            prof.stop()

    run_federated(model, policy, cfg, *data, seed=0, eval_every=R - 1,
                  compression=comp, on_round=on_round, device="cuda")
    wall_ms = 1e3 * (window["t1"] - window["t0"])
    kernels = device_kernels(prof)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    fold = [e for e in kernels if re.search(r"fold_\w*kernel", e.key)]
    fold_ms = sum(e.self_device_time_total for e in fold) / 1e3
    n = R - 2
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    tag = f"[vgg11 profile {'none' if comp is None else comp}]"
    print(f"{tag} rounds 2..{R - 1} ({n}): wall_ms_per_round="
          f"{wall_ms / n:.3f} device_busy_ms_per_round={busy_ms / n:.3f} "
          f"idle_share={1 - busy_ms / wall_ms:.4f} fold_kernel_ms_per_round="
          f"{fold_ms / n:.4f} fold_share_of_busy={fold_ms / busy_ms:.4f} "
          f"fold_launches_per_round={sum(e.count for e in fold) / n:g} "
          f"device_kernel_launches_per_round="
          f"{sum(e.count for e in kernels) / n:g}", flush=True)
    for e in top:
        print(f"{tag}   {e.self_device_time_total / 1e3 / n:9.4f} "
              f"ms/round x{e.count // n:<4d} {e.key[:90]}", flush=True)
    check(busy_ms > 0, "the profiler saw no device time")


# ---------------------------------------------------------------------------
# the other execution backends, HeteroFL, and the round's host time by phase
# ---------------------------------------------------------------------------

# (backend, ExecSpec knobs, grouped fold launches a round at U=10): chunked
# pads 10 clients to 12 in 3 chunks of 4, temporal folds each client alone,
# hierarchical folds each of 2 contiguous regions of 5
BACKEND_CASES = (("chunked", {"chunk_size": 4}, 3), ("temporal", {}, 10),
                 ("hierarchical", {"regions": 2}, 2))
BACKEND_ROUNDS = 3
# a backend's round against the dense backend's from the same params,
# batches and mask, uncompressed or int8: max |difference| <= AGREE_UPDATE
# * max |dense update| (f32 partials summed in another order; cuDNN may
# pick other algorithms for a chunk of 4 than for a cohort of 10)
AGREE_UPDATE = 1e-4


def fold_slices(torch, leaf_F: dict) -> None:
    """The grouped folds at the widths the other backends hand them: one
    client (temporal: (1, L) coefficient rows), a region of 5
    (hierarchical) and a chunk of 4 (chunked), all 38 VGG-11 leaves in f32
    and int8, each against its plain version on the same CUDA tensors."""
    from repro_torch.kernels.adel_agg import (adel_agg_grouped,
                                              adel_agg_grouped_plain,
                                              adel_agg_q8_grouped,
                                              adel_agg_q8_grouped_plain)
    gen = torch.Generator(device="cuda").manual_seed(2)
    sizes = [F for F, n in leaf_F.items() for _ in range(n)]
    ids = list(range(len(sizes)))
    for U in (1, 4, 5):
        coeff = torch.rand((U, len(sizes)), generator=gen, device="cuda")
        grads = [torch.randn((U, 1, F), generator=gen, device="cuda")
                 for F in sizes]
        qs, ss = map(list, zip(*(quantize(torch, g) for g in grads)))
        for name, (tol, _), pairs in (
                ("adel_agg_grouped", TOL["f32"],
                 zip(adel_agg_grouped(grads, ids, coeff),
                     adel_agg_grouped_plain(grads, ids, coeff))),
                ("adel_agg_q8_grouped", TOL["q8"],
                 zip(adel_agg_q8_grouped(qs, ss, ids, coeff),
                     adel_agg_q8_grouped_plain(qs, ss, ids, coeff)))):
            pairs = list(pairs)
            err = max(float((o - r).abs().max()) for o, r in pairs)
            top = max(float(r.abs().max()) for _, r in pairs)
            print(f"[fold slices] {name:19s} U={U} 38 leaves "
                  f"max_abs_err={err:.3e} max_abs={top:.3e}", flush=True)
            check(err <= tol * (1 + top),
                  f"{name} at U={U} disagrees with its plain version: {err}")


def run_rounds(torch, vgg: dict, rounds: int, *, exec=None, policy=None,
               tracer=None, on_round=None, eval_every=None, backend=None):
    """``rounds`` rounds of the VGG-11 cell through the round runtime (the
    loop ``run_federated`` drives), evaluating after the first and the
    last (or every ``eval_every`` rounds); ``backend`` passes a backend
    instance the caller keeps."""
    from repro_torch.fl.runtime import (RoundRuntime, StaticCohortSource,
                                        probe_s_max)
    cfg = vgg["cfg"]
    policy = vgg["policy"] if policy is None else policy
    cx, cy, counts, x_te, y_te = vgg["data"]
    s_max = max(min(probe_s_max(policy, cfg.R), int(cy.shape[1])), 2)
    runtime = RoundRuntime(vgg["model"], policy, exec=exec, tracer=tracer,
                           backend=backend, device="cuda")
    source = StaticCohortSource(cx, cy, counts, device="cuda")
    return runtime.run(source, rounds=rounds, T_max=cfg.T_max, eta=cfg.eta,
                       s_max=s_max, test_x=x_te, test_y=y_te, seed=0,
                       eval_every=eval_every or max(rounds - 1, 1),
                       on_round=on_round)


def timed_rounds(torch, vgg: dict, rounds: int, **kw):
    """(History, wall ms of each round: host clock between synchronized
    ``on_round`` calls, the first from the run's start)."""
    stamps = []

    def on_round(t, params, hist):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, hist = run_rounds(torch, vgg, rounds, on_round=on_round, **kw)
    return hist, [1e3 * (b - a) for a, b in zip([t0] + stamps[:-1], stamps)]


def round_inputs(torch, vgg: dict, policy) -> dict:
    """Round 0's inputs as the runtime draws them (the policy's plan, the
    clients' minibatches) from seeded params."""
    from repro_torch.fl.client import sample_client_batches
    from repro_torch.fl.runtime import Draws, probe_s_max
    cfg, model = vgg["cfg"], vgg["model"]
    cx, cy, counts = (torch.as_tensor(a, device="cuda")
                      for a in vgg["data"][:3])
    draws = Draws(0)
    plan = policy.round(draws, 0)
    s_max = max(min(probe_s_max(policy, cfg.R), int(cy.shape[1])), 2)
    xb, yb, wb = sample_client_batches(
        draws.batch_indices(0, U_MAIN, s_max), cx, cy, counts,
        plan.batch_sizes, s_max)
    return {"params": model.init(torch.Generator().manual_seed(0), "cuda"),
            "arrays": (xb, yb, wb, plan.mask.cuda(), plan.p.cuda()),
            "eta": float(cfg.eta[0]), "plan": plan}


def one_round(torch, vgg: dict, inputs: dict, spec):
    """One round of the backend ``spec`` names on ``inputs``, the cohort
    padded to the backend's width as the runtime pads it."""
    import numpy as np

    from repro_torch.fl.backends import make_backend
    model, plan = vgg["model"], inputs["plan"]
    backend = make_backend(exec=spec, model=model, device="cuda")
    U_pad = backend.cohort_pad(U_MAIN)
    arrays = [a if i == 4 else torch.cat(
        [a, a.new_zeros((U_pad - U_MAIN,) + tuple(a.shape[1:]))])
        for i, a in enumerate(inputs["arrays"])]
    wmasks = None
    if plan.width_ratios is not None:
        r = np.concatenate([plan.width_ratios,
                            np.ones(U_pad - U_MAIN, np.float32)])
        wmasks = model.width_masks(inputs["params"], r)
    out = backend.run_round(inputs["params"], *arrays, inputs["eta"],
                            bias_correct=bool(plan.bias_correct),
                            wmasks=wmasks)
    torch.cuda.synchronize()
    return out


def agreement(torch, inputs: dict, out, dense_out) -> float:
    """max |out - dense| / max |dense update| over every leaf."""
    from repro_torch.tree import tree_leaves
    leaves = list(zip(tree_leaves(out), tree_leaves(dense_out),
                      tree_leaves(inputs["params"])))
    upd = max(float((d - w).abs().max()) for _, d, w in leaves)
    check(upd > 0, "the dense round did not move the params")
    return max(float((a - d).abs().max()) for a, d, _ in leaves) / upd


def fold_launches(prof) -> dict:
    """Device launches of each fold kernel in a profile."""
    out = {"adel_agg_grouped": 0, "adel_agg_q8_grouped": 0, "per_leaf": 0}
    for e in device_kernels(prof):
        if "fold_grouped_q8_kernel" in e.key:
            out["adel_agg_q8_grouped"] += e.count
        elif "fold_grouped_kernel" in e.key:
            out["adel_agg_grouped"] += e.count
        elif re.search(r"\bfold_kernel", e.key):
            out["per_leaf"] += e.count
    return out


def vgg_backends(torch, vgg: dict) -> dict:
    """The chunked, temporal and hierarchical backends on the VGG-11 cell,
    uncompressed and int8: wall a round over 3 rounds, the fold launches a
    round counted by ``torch.profiler`` over 3 more (3 / 10 / 2 grouped
    launches and no other fold launch), and one round from the same params,
    batches and mask against the dense backend's. Returns each fold
    kernel's launches a round on each backend, as the profiler counted
    them."""

    from repro_torch.fl.spec import ExecSpec
    inputs = round_inputs(torch, vgg, vgg["policy"])
    counters = fold_counters()
    R = BACKEND_ROUNDS
    per_path = {"adel_agg": {}, "adel_agg_q8": {}}
    for comp in (None, "int8"):
        dense_out = one_round(torch, vgg, inputs, ExecSpec(compression=comp))
        kernel = "adel_agg_grouped" if comp is None else "adel_agg_q8_grouped"
        for name, knobs, per_round in BACKEND_CASES:
            spec = ExecSpec(backend=name, compression=comp, **knobs)
            tag = f"[vgg11 backends] {name:12s} {comp or 'none':4s}"
            hist, wall = timed_rounds(torch, vgg, R, exec=spec)
            check(all(math.isfinite(v) for v in hist.train_loss),
                  f"{tag} loss not finite")
            for k in counters.values():
                k.launches = 0
            with device_profile(torch) as prof:
                run_rounds(torch, vgg, R, exec=spec)
            seen = fold_launches(prof)
            fired = {k: c.launches for k, c in counters.items()}
            ratio = agreement(torch, inputs,
                              one_round(torch, vgg, inputs, spec), dense_out)
            print(f"{tag} wall_ms_per_round={[round(w, 3) for w in wall]} "
                  f"steady_ms={wall[1]:.3f} fold_launches_per_round "
                  + " ".join(f"{k}={v / R:g}" for k, v in seen.items())
                  + f" (wrappers: {fired}) one_round max|params-dense|/"
                  f"max|dense update|={ratio:.3e}", flush=True)
            want = {k: 0 for k in seen}
            want[kernel] = per_round * R
            check(seen == want, f"{tag} fold launches {seen}, want {want}")
            check(fired == {k: (per_round * R if k == kernel else 0)
                            for k in fired},
                  f"{tag} wrapper launch counts {fired}")
            check(ratio <= AGREE_UPDATE,
                  f"{tag} one round disagrees with dense: {ratio:.3e} of "
                  f"the update")
            per_path["adel_agg" if comp is None else "adel_agg_q8"][name] = \
                seen[kernel] / R
    return per_path


def vgg_heterofl(torch, vgg: dict) -> None:
    """HeteroFL on the VGG-11 cell: 3 rounds on the dense and the chunked
    backends (finite losses, no fold kernel: the width-overlap mean is
    plain PyTorch, as in the reference), and one chunked round against the
    dense round on the same inputs."""
    from repro_torch.core.baselines import make_policy
    from repro_torch.fl.spec import ExecSpec
    policy = make_policy("heterofl", vgg["cfg"], device="cuda")
    counters = fold_counters()
    inputs = round_inputs(torch, vgg, policy)
    part = inputs["plan"].mask[:, 0].tolist()
    print(f"[vgg11 heterofl] width_ratios={policy.ratios.tolist()} "
          f"round-1 participants={part}", flush=True)
    dense_out = one_round(torch, vgg, inputs, ExecSpec())
    for spec in (ExecSpec(), ExecSpec(backend="chunked", chunk_size=4)):
        for k in counters.values():
            k.launches = 0
        hist, wall = timed_rounds(torch, vgg, BACKEND_ROUNDS, exec=spec,
                                  policy=policy)
        fired = {k: c.launches for k, c in counters.items()}
        finite = all(math.isfinite(v) for v in hist.train_loss
                     + hist.accuracy)
        ratio = (0.0 if spec.backend == "dense" else agreement(
            torch, inputs, one_round(torch, vgg, inputs, spec), dense_out))
        print(f"[vgg11 heterofl] {spec.backend:8s} wall_ms_per_round="
              f"{[round(w, 3) for w in wall]} loss={hist.train_loss} "
              f"acc={hist.accuracy} finite={finite} fold_launches={fired}"
              + ("" if spec.backend == "dense" else
                 f" one_round max|params-dense|/max|dense update|="
                 f"{ratio:.3e}"), flush=True)
        check(finite, "HeteroFL loss or accuracy not finite")
        check(not any(fired.values()),
              f"a fold kernel ran in a HeteroFL round: {fired}")
        check(ratio <= AGREE_UPDATE,
              f"HeteroFL chunked round disagrees with dense: {ratio:.3e}")


PHASE_NAMES = ("cohort", "plan", "stack", "local_train", "aggregate", "eval")


def vgg_phases(torch, vgg: dict) -> None:
    """Where a steady dense VGG-11 round's host time goes, uncompressed
    and int8: the tracer's spans of rounds 2-4 by phase against the traced
    and the untraced wall a round, and the ``aggregate`` phase split into
    compress, fold and update by this script's own synchronized timers
    around those calls of the dense backend (a third run)."""
    from repro_torch import obs
    from repro_torch.fl import backends as bk
    from repro_torch.fl.spec import ExecSpec
    R = ROUNDS_MAIN
    steady = range(2, R)                       # 1-based rounds 2 .. R-1
    for comp in (None, "int8"):
        spec = ExecSpec(compression=comp)
        tag = f"[vgg11 phases {comp or 'none'}]"
        _, wall = timed_rounds(torch, vgg, R, exec=spec)
        untraced = sum(wall[r - 1] for r in steady) / len(steady)
        sink = obs.MemorySink()
        tracer = obs.Tracer(sink)
        _, hist = run_rounds(torch, vgg, R, exec=spec, tracer=tracer)
        table = obs.phase_table(sink.records)
        rows = obs.ledger_rows(sink.records)
        check(len(rows) == R and hist.telemetry["phases"],
              f"{tag} the tracer recorded {len(rows)} rounds")
        ms = {ph: 1e3 * sum(table[r].get(ph, 0.0) for r in steady)
              / len(steady) for ph in PHASE_NAMES}
        eval_ms = 1e3 * sum(table[r]["eval"] for r in (1, R)) / 2
        traced = 1e3 * sum(rows[r - 1]["wall_round_s"]
                           for r in steady) / len(steady)
        total = sum(ms.values())
        print(f"{tag} host ms a round by phase (rounds 2-4, traced, "
              f"synchronized at span ends): "
              + " ".join(f"{k}={v:.3f}" for k, v in ms.items())
              + f" | sum={total:.3f} traced_wall={traced:.3f} "
              f"untraced_wall={untraced:.3f} | eval ms in the rounds that "
              f"evaluate (1, {R})={eval_ms:.3f}", flush=True)
        check(all(ms[ph] > 0 for ph in PHASE_NAMES[:-1]),
              f"{tag} a phase recorded no time: {ms}")
        check(total <= traced * 1.001,
              f"{tag} phases sum past the round's wall: {total} > {traced}")
        # the aggregate phase split by the script's own timers
        split = {"compress": [], "fold": [], "update": []}
        saved = {n: getattr(bk, n) for n in ("compress_deltas",
                                             "aggregate_compressed",
                                             "aggregate_grads",
                                             "apply_update")}

        def timer(part, fn):
            def run(*a, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **k)
                torch.cuda.synchronize()
                split[part].append(1e3 * (time.perf_counter() - t0))
                return out
            return run

        bk.compress_deltas = timer("compress", saved["compress_deltas"])
        bk.aggregate_compressed = timer("fold", saved["aggregate_compressed"])
        bk.aggregate_grads = timer("fold", saved["aggregate_grads"])
        bk.apply_update = timer("update", saved["apply_update"])
        try:
            run_rounds(torch, vgg, R, exec=spec)
        finally:
            for n, fn in saved.items():
                setattr(bk, n, fn)
        parts = {k: (sum(v[r - 1] for r in steady) / len(steady) if v else
                     0.0) for k, v in split.items()}
        print(f"{tag} aggregate split (rounds 2-4, script timers): "
              + " ".join(f"{k}={v:.3f}" for k, v in parts.items())
              + f" | sum={sum(parts.values()):.3f} aggregate_span="
              f"{ms['aggregate']:.3f}", flush=True)
        check(len(split["fold"]) == R and len(split["update"]) == R,
              f"{tag} the timers saw {split}")


# ---------------------------------------------------------------------------
# the shard_map backend on torch.distributed, and the prefetch round loop
# ---------------------------------------------------------------------------

SHARD_ROUNDS = 3
PIPE_ROUNDS = 5
GLOO_RANKS = 2
SPAWN_TIMEOUT_S = 420


def nccl_kernels(prof) -> dict:
    """Device launches of each NCCL kernel in a profile, by name."""
    return {e.key[:60]: e.count for e in device_kernels(prof)
            if "nccl" in e.key.lower()}


def vgg_shard_map_nccl(torch, vgg: dict) -> dict:
    """shard_map over the one-rank NCCL group this process holds, on the
    VGG-11 cell, uncompressed and int8: one round from the same params,
    batches and mask against the dense backend's (bit-identity expected:
    the all_reduce of one rank is a copy), wall a round over 3 rounds, and
    over 3 more the grouped fold launches (one a round, no other fold
    launch) and the NCCL kernels that ``torch.profiler`` counts. Returns
    each fold kernel's launches a round."""

    from repro_torch.fl.spec import ExecSpec
    from repro_torch.tree import tree_leaves
    inputs = round_inputs(torch, vgg, vgg["policy"])
    counters = fold_counters()
    R = SHARD_ROUNDS
    per_path = {}
    for comp in (None, "int8"):
        kernel = "adel_agg_grouped" if comp is None else "adel_agg_q8_grouped"
        tag = f"[vgg11 shard_map] nccl x1 {comp or 'none':4s}"
        spec = ExecSpec(backend="shard_map", compression=comp)
        dense_out = one_round(torch, vgg, inputs, ExecSpec(compression=comp))
        out = one_round(torch, vgg, inputs, spec)
        ratio = agreement(torch, inputs, out, dense_out)
        same = all(torch.equal(a, b) for a, b in zip(tree_leaves(out),
                                                     tree_leaves(dense_out)))
        hist, wall = timed_rounds(torch, vgg, R, exec=spec)
        check(all(math.isfinite(v) for v in hist.train_loss),
              f"{tag} loss not finite")
        for k in counters.values():
            k.launches = 0
        with device_profile(torch) as prof:
            run_rounds(torch, vgg, R, exec=spec)
        seen = fold_launches(prof)
        fired = {k: c.launches for k, c in counters.items()}
        nccl = nccl_kernels(prof)
        print(f"{tag} wall_ms_per_round={[round(w, 3) for w in wall]} "
              f"steady_ms={wall[1]:.3f} fold_launches_per_round "
              + " ".join(f"{k}={v / R:g}" for k, v in seen.items())
              + f" (wrappers: {fired}) nccl_kernels_per_round="
              f"{sum(nccl.values()) / R:g} {nccl} one_round "
              f"max|params-dense|/max|dense update|={ratio:.3e} "
              f"bit_identical={same}", flush=True)
        want = {k: 0 for k in seen}
        want[kernel] = R
        check(seen == want, f"{tag} fold launches {seen}, want {want}")
        check(fired == {k: (R if k == kernel else 0) for k in fired},
              f"{tag} wrapper launch counts {fired}")
        check(ratio <= AGREE_UPDATE,
              f"{tag} one round disagrees with dense: {ratio:.3e}")
        per_path["adel_agg" if comp is None else "adel_agg_q8"] = seen[kernel] / R
    return per_path


def shard_rank(rank: int, world: int, tmp: str) -> None:
    """One spawned rank of ``[vgg11 shard_map] gloo``: joins a gloo group
    over a FileStore in ``tmp``, builds the VGG-11 cell on ``cuda:0`` with
    its parent's schedule, and for each wire format runs one round from
    the parent's inputs (held against the parent's dense update) and 3
    rounds through the runtime; writes its report to ``rank<r>.json``. An
    exception exits the process non-zero."""
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist

    from repro_torch.fl.spec import ExecSpec
    from repro_torch.tree import tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    store = dist.FileStore(str(Path(tmp) / "gloo_store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        blob = torch.load(Path(tmp) / "inputs.pt", weights_only=False)
        vgg = vgg_setup(torch, schedule=blob["schedule"])
        inputs = {"params": tree_map(lambda a: a.cuda(), blob["params"]),
                  "arrays": tuple(a.cuda() for a in blob["arrays"]),
                  "eta": blob["eta"], "plan": blob["plan"]}
        counters = fold_counters()
        report = {"rank": rank, "device": torch.cuda.get_device_name(0)}
        for name, comp in (("none", None), ("int8", "int8")):
            spec = ExecSpec(backend="shard_map", compression=comp)
            for k in counters.values():
                k.launches = 0
            out = one_round(torch, vgg, inputs, spec)
            dense = tree_map(lambda a: a.cuda(), blob["dense"][name])
            ratio = agreement(torch, inputs, out, dense)
            hist, wall = timed_rounds(torch, vgg, SHARD_ROUNDS, exec=spec)
            report[name] = {
                "ratio": ratio, "wall_ms": wall, "loss": hist.train_loss,
                "fired": {k: c.launches for k, c in counters.items()}}
        (Path(tmp) / f"rank{rank}.json").write_text(json.dumps(report))
    finally:
        dist.destroy_process_group()


def vgg_shard_map_gloo(torch, vgg: dict, tmp: str) -> None:
    """shard_map over 2 spawned ranks on ``cuda:0`` joined by gloo (NCCL
    refuses two ranks on one card; gloo sums CUDA tensors through the
    host): each rank trains and folds 5 of the 10 clients. Both exit codes
    are checked; rank 0's round is held to 1e-4 of the parent's dense
    update, and each rank launches one grouped fold a round."""
    import multiprocessing

    from repro_torch.fl.spec import ExecSpec
    from repro_torch.tree import tree_map
    inputs = round_inputs(torch, vgg, vgg["policy"])
    cpu = {"schedule": vgg["policy"].schedule, "eta": inputs["eta"],
           "plan": inputs["plan"],
           "params": tree_map(lambda a: a.cpu(), inputs["params"]),
           "arrays": tuple(a.cpu() for a in inputs["arrays"]), "dense": {}}
    for name, comp in (("none", None), ("int8", "int8")):
        cpu["dense"][name] = tree_map(lambda a: a.cpu(), one_round(
            torch, vgg, inputs, ExecSpec(compression=comp)))
    torch.save(cpu, Path(tmp) / "inputs.pt")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=shard_rank, args=(r, GLOO_RANKS, tmp))
             for r in range(GLOO_RANKS)]
    t0 = time.perf_counter()
    for proc in procs:
        proc.start()
    try:
        deadline = t0 + SPAWN_TIMEOUT_S
        for proc in procs:
            proc.join(max(deadline - time.perf_counter(), 1.0))
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.terminate()
                proc.join(30)
                if proc.is_alive():
                    proc.kill()
                    proc.join(30)
    codes = [proc.exitcode for proc in procs]
    print(f"[vgg11 shard_map] gloo x{GLOO_RANKS} on cuda:0: exit codes "
          f"{codes} in {time.perf_counter() - t0:.1f} s", flush=True)
    check(codes == [0] * GLOO_RANKS, f"a spawned rank failed: {codes}")
    R = SHARD_ROUNDS
    for rank in range(GLOO_RANKS):
        report = json.loads((Path(tmp) / f"rank{rank}.json").read_text())
        for name, kernel in (("none", "adel_agg_grouped"),
                             ("int8", "adel_agg_q8_grouped")):
            rep = report[name]
            print(f"[vgg11 shard_map] gloo x{GLOO_RANKS} rank {rank} "
                  f"{name:4s} wall_ms_per_round="
                  f"{[round(w, 3) for w in rep['wall_ms']]} loss="
                  f"{rep['loss']} fold wrappers (1 + {R} rounds)="
                  f"{rep['fired']} one_round max|params-dense|/max|dense "
                  f"update|={rep['ratio']:.3e}", flush=True)
            check(all(math.isfinite(v) for v in rep["loss"]),
                  f"gloo rank {rank} {name}: loss not finite")
            check(rep["fired"] == {k: (R + 1 if k == kernel else 0)
                                   for k in rep["fired"]},
                  f"gloo rank {rank} {name}: fold launches {rep['fired']}")
            check(rep["ratio"] <= AGREE_UPDATE,
                  f"gloo rank {rank} {name}: one round disagrees with the "
                  f"dense update: {rep['ratio']:.3e}")


def idle_share(torch, vgg: dict, spec) -> tuple:
    """(wall ms, device-busy ms) a steady round (rounds 2 .. R-1 of
    ``PIPE_ROUNDS``, evaluating every round) from a CUDA-only
    ``torch.profiler`` trace between synchronized ``on_round`` calls."""
    from torch.profiler import ProfilerActivity, profile
    R = PIPE_ROUNDS
    prof = profile(activities=[ProfilerActivity.CUDA])
    window = {}

    def on_round(t, params, hist):
        torch.cuda.synchronize()
        if t == 0:
            prof.start()
            open_window(torch)
            torch.cuda.synchronize()
            window["t0"] = time.perf_counter()
        elif t == R - 2:
            window["t1"] = time.perf_counter()
            close_window(torch)
            prof.stop()

    run_rounds(torch, vgg, R, exec=spec, eval_every=1, on_round=on_round)
    busy = sum(e.self_device_time_total for e in device_kernels(prof)) / 1e3
    n = R - 2
    return 1e3 * (window["t1"] - window["t0"]) / n, busy / n


PIPE_CASES = (("dense", None), ("dense", "int8"), ("shard_map", None))
# timed runs: PIPE_TURNS x (serial, prefetch, prefetch, serial)
PIPE_TURNS = 3
PIPE_COUNTERS = ("prefetch_rounds", "prefetch_overlap_s", "dispatch_wait_s",
                 "warm_up_s")


def vgg_pipeline(torch, vgg: dict) -> None:
    """Serial against prefetch on the VGG-11 cell, 5 rounds evaluating
    every round: dense uncompressed and int8, and shard_map over the
    one-rank NCCL group this process holds. History equal and params
    bit-equal under ``cudnn.deterministic`` (set for the comparison and
    restored; whether serial against serial is bit-identical without it is
    printed). For each mode: wall a steady round (rounds 2-4, host clock
    between synchronized ``on_round`` calls) over 12 runs in turns (serial,
    prefetch, prefetch, serial; three times); the device-idle share from
    ``torch.profiler``; and a traced run's pipeline counters."""
    from repro_torch import obs
    from repro_torch.fl.spec import ExecSpec
    from repro_torch.tree import tree_leaves
    R = PIPE_ROUNDS

    def same(a, b):
        (pa, ha), (pb, hb) = a, b
        return ha.as_dict() == hb.as_dict() and all(
            torch.equal(x, y) for x, y in zip(tree_leaves(pa),
                                              tree_leaves(pb)))

    for backend, comp in PIPE_CASES:
        tag = f"[vgg11 pipeline] {backend:9s} {comp or 'none':4s}"
        specs = {m: ExecSpec(backend=backend, compression=comp, pipeline=m)
                 for m in ("serial", "prefetch")}
        serial_twice = same(
            *(run_rounds(torch, vgg, R, exec=specs["serial"], eval_every=1)
              for _ in range(2)))
        flag = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            runs = {m: run_rounds(torch, vgg, R, exec=specs[m], eval_every=1)
                    for m in specs}
        finally:
            torch.backends.cudnn.deterministic = flag
        identical = same(runs["serial"], runs["prefetch"])
        hist = runs["prefetch"][1]
        print(f"{tag} prefetch_vs_serial_bit_identical(cudnn.deterministic)="
              f"{identical} serial_vs_serial_bit_identical(default)="
              f"{serial_twice} rounds={hist.rounds} acc={hist.accuracy} "
              f"loss={hist.train_loss}", flush=True)
        check(identical, f"{tag} prefetch is not bit-identical to serial")
        check(all(math.isfinite(v) for v in hist.train_loss),
              f"{tag} loss not finite")
        walls = {"serial": [], "prefetch": []}
        for m in ("serial", "prefetch", "prefetch", "serial") * PIPE_TURNS:
            _, wall = timed_rounds(torch, vgg, R, exec=specs[m],
                                   eval_every=1)
            walls[m].append(sum(wall[1:R - 1]) / (R - 2))
        for m, spec in specs.items():
            wall_ms, busy_ms = idle_share(torch, vgg, spec)
            tracer = obs.Tracer(obs.MemorySink())
            _, traced = run_rounds(torch, vgg, R, exec=spec, eval_every=1,
                                   tracer=tracer)
            counters = traced.telemetry["counters"]
            phases = traced.telemetry["phases"]
            planner = {ph: 1e3 * phases[ph]["total_s"] / phases[ph]["count"]
                       for ph in ("plan", "stack")}
            print(f"{tag} {m:8s} steady_wall_ms_per_round (rounds 2-4, "
                  f"turns)={[round(w, 3) for w in walls[m]]} mean="
                  f"{sum(walls[m]) / len(walls[m]):.3f} profiled: "
                  f"wall_ms_per_round={wall_ms:.3f} device_busy_ms_per_round="
                  f"{busy_ms:.3f} idle_share={1 - busy_ms / wall_ms:.4f} "
                  f"traced: plan_ms={planner['plan']:.3f} stack_ms="
                  f"{planner['stack']:.3f} (a round, where the planner ran) "
                  + " ".join(f"{k}={counters.get(k, 0)}"
                             for k in PIPE_COUNTERS), flush=True)
            if m == "prefetch":
                check(counters.get("prefetch_rounds") == R - 1
                      and counters.get("warm_up_s", 0) > 0,
                      f"{tag} prefetch counters missing: {counters}")
    # the buffered backend's carry ring under prefetch: the worker plans
    # ahead while the main thread banks and folds
    tag = "[vgg11 pipeline] buffered  none"
    flag = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        pair = [run_rounds(torch, vgg, R, eval_every=1, exec=ExecSpec(
            backend="buffered", pipeline=m, **BUFFERED))
            for m in ("serial", "prefetch")]
    finally:
        torch.backends.cudnn.deterministic = flag
    identical = same(*pair)
    print(f"{tag} prefetch_vs_serial_bit_identical(cudnn.deterministic)="
          f"{identical} rounds={pair[1][1].rounds} acc={pair[1][1].accuracy}"
          f" loss={pair[1][1].train_loss}", flush=True)
    check(identical, f"{tag} prefetch is not bit-identical to serial")


# ---------------------------------------------------------------------------
# the buffered semi-async backend, the fleet engine and the fleet scenarios
# ---------------------------------------------------------------------------

BUFFERED = {"lam": 0.5, "max_age": 4, "buffer_cap": 4}
FLEET_SIZES = (10_000, 1_000_000)
FLEET_ROUNDS = 3
FLEET_COHORT = 16
FLEET_REGIONS = 4
FLEET_SHARDS = 1024
SCENARIO_RUNS = ("longtail-mobile-buffered", "longtail-mobile-diurnal-replan",
                 "longtail-mobile-diurnal-int8")


def slot_fold_error(torch, slot: dict, w, ids: list, comp) -> tuple:
    """One carried slot's fold through its kernel and through the plain
    version, on the same banked CUDA payload and coefficients
    ``c_late * w``: (max |kernel - plain|, max |plain|)."""
    from repro_torch.kernels.adel_agg import (adel_agg_grouped,
                                              adel_agg_grouped_plain,
                                              adel_agg_q8_grouped,
                                              adel_agg_q8_grouped_plain)
    from repro_torch.kernels.ops import leaf_dims
    from repro_torch.tree import tree_leaves
    coeffs = (slot["c_late"] * torch.from_numpy(w)[:, None]).cuda()
    if comp is None:
        flat = [g.reshape(g.shape[0], *leaf_dims(g.shape[1:], i))
                for g, i in zip(tree_leaves(slot["banked"]), ids)]
        pairs = zip(adel_agg_grouped(flat, ids, coeffs),
                    adel_agg_grouped_plain(flat, ids, coeffs))
    else:
        qs = [q for q, _ in slot["banked"]]
        ss = [sc for _, sc in slot["banked"]]
        pairs = zip(adel_agg_q8_grouped(qs, ss, ids, coeffs),
                    adel_agg_q8_grouped_plain(qs, ss, ids, coeffs))
    pairs = list(pairs)
    return (max(float((o - r).abs().max()) for o, r in pairs),
            max(float(r.abs().max()) for _, r in pairs))


def vgg_buffered(torch, vgg: dict) -> dict:
    """The buffered backend on the VGG-11 cell (U=10, ADEL, 5 rounds,
    ``lam=0.5``, ``max_age=4``, ``buffer_cap=4``), uncompressed and int8:
    ``lam=0`` bit-identical to dense under ``cudnn.deterministic``; with
    ``lam>0`` one grouped fold launch a round for the on-time fold plus one
    a carry slot folded that round (the round's ``last_carry`` staleness
    histogram has one entry a slot), by the wrappers' counts a round and by
    ``torch.profiler`` a round over a second run, with no other fold
    launch; each carried slot's fold against the plain fold of the same
    banked payload and coefficients; a round's carry counts, wall and peak
    memory (and the dense runs' peak). Returns each fold kernel's launches
    a round."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.fl.backends import make_backend
    from repro_torch.fl.spec import ExecSpec
    from repro_torch.tree import tree_leaves
    R = ROUNDS_MAIN
    model = vgg["model"]
    ids = tree_leaves(model.layer_ids(model.init(torch.Generator(), "meta")))
    counters = fold_counters()

    def same(a, b):
        (pa, ha), (pb, hb) = a, b
        return ha.as_dict() == hb.as_dict() and all(
            torch.equal(x, y) for x, y in zip(tree_leaves(pa),
                                              tree_leaves(pb)))

    per_path = {}
    for comp in (None, "int8"):
        tag = f"[vgg11 buffered] {comp or 'none':4s}"
        kernel = "adel_agg_grouped" if comp is None else "adel_agg_q8_grouped"
        flag = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        torch.cuda.reset_peak_memory_stats()
        try:
            runs = [run_rounds(torch, vgg, R, exec=ExecSpec(
                backend=b, compression=comp)) for b in ("dense", "buffered")]
        finally:
            torch.backends.cudnn.deterministic = flag
        identical = same(*runs)
        dense_peak = torch.cuda.max_memory_allocated() / 2**20
        del runs
        print(f"{tag} lam=0 bit_identical_to_dense(cudnn.deterministic)="
              f"{identical} peak_mb(dense and lam=0)={dense_peak:.1f}",
              flush=True)
        check(identical, f"{tag} lam=0 is not the dense round")

        bk = make_backend("buffered", model, compression=comp,
                          device="cuda", **BUFFERED)
        folds, fold_slot = [], bk._fold_slot

        def spy(params, slot, w, fold_slot=fold_slot, folds=folds):
            folds.append((slot, w))
            return fold_slot(params, slot, w)

        bk._fold_slot = spy
        rows = []
        marks = {"t": None, "n": 0}

        def on_round(t, params, hist):
            torch.cuda.synchronize()
            now = time.perf_counter()
            fired = sum(c.launches for c in counters.values())
            rows.append({"carry": dict(bk.last_carry),
                         "wall_ms": 1e3 * (now - marks["t"]),
                         "peak_mb": torch.cuda.max_memory_allocated() / 2**20,
                         "launches": fired - marks["n"],
                         "own": counters[kernel].launches})
            marks["t"], marks["n"] = now, fired

        for k in counters.values():
            k.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        marks["t"] = time.perf_counter()
        _, hist = run_rounds(torch, vgg, R, backend=bk, on_round=on_round)
        fired = {k: c.launches for k, c in counters.items()}
        want_rounds = [1 + len(r["carry"]["stale"]) for r in rows]
        for t, r in enumerate(rows):
            c = r["carry"]
            print(f"{tag} round {t + 1}: carried_in={c['carried_in']} "
                  f"carried_out={c['carried_out']} carried_dropped="
                  f"{c['carried_dropped']} stale={c['stale']} slots_folded="
                  f"{len(c['stale'])} fold_launches={r['launches']} "
                  f"wall_ms={r['wall_ms']:.3f} peak_mb={r['peak_mb']:.1f}",
                  flush=True)
        check([r["launches"] for r in rows] == want_rounds,
              f"{tag} fold launches a round {[r['launches'] for r in rows]}, "
              f"want 1 + the slots folded {want_rounds}")
        check(fired == {k: (sum(want_rounds) if k == kernel else 0)
                        for k in fired},
              f"{tag} wrapper launch counts {fired}")
        check(sum(want_rounds) > R, f"{tag} no carried slot was folded")
        check(all(math.isfinite(v) for v in hist.train_loss + hist.accuracy),
              f"{tag} loss or accuracy not finite")
        check(len(folds) == sum(want_rounds) - R,
              f"{tag} {len(folds)} slot folds, want {sum(want_rounds) - R}")
        # each carried slot's fold against its plain version (these
        # launches come after the counts were read)
        errs = [slot_fold_error(torch, slot, w, ids, comp)
                for slot, w in folds]
        tol = TOL["f32" if comp is None else "q8"][0]
        worst = max(e / (1 + top) for e, top in errs)
        print(f"{tag} carried-slot folds={len(errs)} max_abs_err="
              f"{max(e for e, _ in errs):.3e} max_abs="
              f"{max(t for _, t in errs):.3e} (kernel vs plain on the banked "
              f"payload) acc={hist.accuracy} loss={hist.train_loss}",
              flush=True)
        check(worst <= tol, f"{tag} a slot fold disagrees with its plain "
                            f"version: {worst:.3e}")
        del folds[:], errs
        del bk._fold_slot                 # the spy held the backend
        # the same run under the profiler, one profile a round: device
        # launches by kernel name against the round's carry
        prof = {}

        def start():
            prof["on"] = profile(activities=[ProfilerActivity.CUDA])
            prof["on"].start()
            open_window(torch)

        def on_round_prof(t, params, hist):
            close_window(torch)
            prof["on"].stop()
            prof.setdefault("rows", []).append(
                (fold_launches(prof["on"]), 1 + len(bk.last_carry["stale"])))
            start()

        start()
        run_rounds(torch, vgg, R, backend=bk, on_round=on_round_prof)
        prof["on"].stop()               # the window after the last round
        for t, (seen, n) in enumerate(prof["rows"]):
            want = {k: 0 for k in seen}
            want[kernel] = n
            check(seen == want, f"{tag} round {t + 1}: profiled fold "
                                f"launches {seen}, want {want}")
        print(f"{tag} profiler fold_launches a round="
              f"{[seen[kernel] for seen, _ in prof['rows']]} (1 + slots "
              f"folded: {[n for _, n in prof['rows']]}; no other fold "
              f"kernel)", flush=True)
        per_path["adel_agg" if comp is None else "adel_agg_q8"] = \
            want_rounds
        # dense against buffered, steady rounds 2-4, in turns
        walls = {"dense": [], "buffered": []}
        for name in ("dense", "buffered", "buffered", "dense"):
            bk.reset_state()
            _, wall = timed_rounds(torch, vgg, R, **(
                {"backend": bk} if name == "buffered" else
                {"exec": ExecSpec(compression=comp)}))
            walls[name].append(sum(wall[1:R - 1]) / (R - 2))
        print(f"{tag} steady wall ms a round (rounds 2-4, in turns): "
              + " ".join(f"{k}={[round(w, 3) for w in v]}"
                         for k, v in walls.items()), flush=True)
        bk.reset_state()
        del bk, prof
        torch.cuda.empty_cache()
    return per_path


def vgg_fleet(torch, vgg: dict) -> dict:
    """``run_fleet`` at full VGG-11 width on ``parametric:longtail-mobile``
    at 10,000 and 1,000,000 devices, Bernoulli(0.7) availability, cohort
    16, the hierarchical backend over 4 edge regions, the cell's synthetic
    CIFAR over 1,024 shards (``partition_fleet``), 3 rounds: region ids
    from the population (the ledger's region census equals the distinct
    ``id % 4`` of each round's cohort, redrawn here from the same seed),
    one grouped fold launch a non-empty region a round by the wrappers and
    by ``torch.profiler`` and no other fold launch, finite losses, and the
    ``cohort`` span's host ms at both sizes. Returns the launches a round
    at 1,000,000 devices."""
    import numpy as np

    from repro_torch import obs
    from repro_torch.fl.spec import ExecSpec
    from repro_torch.fleet import make_population, partition_fleet, run_fleet
    model = vgg["model"]
    data = partition_fleet(*vgg["raw"], FLEET_SHARDS, alpha=0.5, seed=0)
    counters = fold_counters()
    kw = dict(availability="bernoulli", availability_kwargs=(("rate", 0.7),),
              regions=FLEET_REGIONS)
    cohort_ms, out = {}, None
    for size in FLEET_SIZES:
        tag = f"[vgg11 fleet] {size:>9,d} devices"
        pop = make_population("parametric:longtail-mobile", size=size, **kw)
        redraw = make_population("parametric:longtail-mobile", size=size,
                                 **kw)
        rng = np.random.default_rng([2077, 0])
        want_regions = [len(np.unique(redraw.sample_cohort(
            t, rng, U=FLEET_COHORT).ids % FLEET_REGIONS))
            for t in range(FLEET_ROUNDS)]
        sink = obs.MemorySink()
        for k in counters.values():
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with device_profile(torch) as prof:
            _, hist = run_fleet(
                model, pop, data=data, rounds=FLEET_ROUNDS,
                cohort_size=FLEET_COHORT,
                exec=ExecSpec(backend="hierarchical", regions=FLEET_REGIONS),
                T_max=FLEET_ROUNDS * model.L * 0.85, eta0=0.05,
                eta_decay=0.02, solver_steps=300, seed=0,
                tracer=obs.Tracer(sink), device="cuda")
        wall = time.perf_counter() - t0 - PROFILE_MARGIN_S
        rows = obs.ledger_rows(sink.records)
        seen = fold_launches(prof)
        fired = {k: c.launches for k, c in counters.items()}
        phases = hist.telemetry["phases"]
        cohort_ms[size] = (1e3 * phases["cohort"]["total_s"]
                           / phases["cohort"]["count"])
        regions = [r["regions"] for r in rows]
        print(f"{tag} rounds={hist.rounds} available={hist.available} "
              f"regions_a_round={regions} (cohort ids mod 4: "
              f"{want_regions}) fold_launches={seen} (wrappers: {fired}) "
              f"loss={hist.train_loss} acc={hist.accuracy} cohort_span_ms="
              f"{cohort_ms[size]:.3f} local_train_ms="
              f"{1e3 * phases['local_train']['total_s'] / FLEET_ROUNDS:.3f} "
              f"a round, run_s={wall:.3f} (solve included)", flush=True)
        check(len(rows) == FLEET_ROUNDS, f"{tag} ran {len(rows)} rounds")
        check(regions == want_regions,
              f"{tag} regions {regions} are not the cohort's ids mod "
              f"{FLEET_REGIONS}: {want_regions}")
        want = {k: 0 for k in seen}
        want["adel_agg_grouped"] = sum(regions)
        check(seen == want, f"{tag} fold launches {seen}, want {want}")
        check(fired == {k: (sum(regions) if k == "adel_agg_grouped" else 0)
                        for k in fired}, f"{tag} wrapper counts {fired}")
        check(all(math.isfinite(v) for v in hist.train_loss),
              f"{tag} loss not finite")
        out = regions
    small, large = (cohort_ms[n] for n in FLEET_SIZES)
    print(f"[vgg11 fleet] cohort span host ms a round: "
          + " ".join(f"{n:,d} devices={v:.3f}" for n, v in cohort_ms.items())
          + f" (ratio {large / small:.3f})", flush=True)
    return out


def fleet_scenarios(torch) -> None:
    """Three of the registry's scenarios on the card at their published
    size and rounds (``run_scenario``): rounds run, skipped rounds, replan
    events, carried totals, final accuracy and the fold launches; the
    replan scenario's executed deadlines sum to at most ``T_max``."""
    from repro_torch import obs
    from repro_torch.fleet.scenarios import get_scenario, run_scenario
    counters = fold_counters()
    for name in SCENARIO_RUNS:
        scn = get_scenario(name)
        sink = obs.MemorySink()
        for k in counters.values():
            k.launches = 0
        t0 = time.perf_counter()
        res = run_scenario(scn, verbose=False, tracer=obs.Tracer(sink),
                           device="cuda")
        wall = time.perf_counter() - t0
        rows = obs.ledger_rows(sink.records)
        counts = res["telemetry"]["counters"]
        phases = res["telemetry"]["phases"]
        host = {ph: round(1e3 * phases[ph]["total_s"]
                          / phases[ph]["count"], 3)
                for ph in ("replan", "plan", "local_train") if ph in phases}
        carried = {k: sum(r.get(k, 0) for r in rows)
                   for k in ("carried_in", "carried_out", "carried_dropped")}
        T_max = scn.rounds * 3 * 0.5          # run_fleet's default, MLP L=3
        spent = sum(res["deadlines"])
        fired = {k: c.launches for k, c in counters.items()}
        replans = [(r["round"], r["reachable"], r["U_est"],
                    round(sum(r["T_tail"]), 4)) for r in res["replans"]]
        print(f"[fleet scenarios] {name}: fleet={res['fleet']['size']} "
              f"cohort={res['cohort']['size']} backend={res['backend']} "
              f"rounds_run={len(rows)} skipped="
              f"{counts.get('rounds_skipped', 0)} replans (round, "
              f"reachable, U_est, tail sum)={replans}"
              f" carried={carried} final_acc={res['accuracy'][-1]:.4f} "
              f"deadline_sum={spent:.6f} T_max={T_max} "
              f"fold_launches={fired} host_ms_a_call={host} "
              f"run_s={wall:.3f}", flush=True)
        check(rows and all(math.isfinite(v) for v in res["train_loss"]),
              f"{name}: no rounds or a loss not finite")
        check(spent <= T_max * (1 + 1e-6),
              f"{name}: deadlines sum {spent} past T_max {T_max}")
        if name.endswith("-replan"):
            check(res["replans"], f"{name}: no replan event")
        if res["backend"] == "buffered":
            check(carried["carried_in"] > 0, f"{name}: nothing carried in")
        kernel = ("adel_agg_q8_grouped" if res["compression"]["mode"] == "int8"
                  else "adel_agg_grouped")
        check(fired[kernel] >= len(rows) and not any(
            v for k, v in fired.items() if k != kernel),
              f"{name}: fold launches {fired}")


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


# ---------------------------------------------------------------------------
# the LM path: flash attention and the SSD chunk scan
# ---------------------------------------------------------------------------

# (rtol, atol) of an LM kernel against its plain version on the same CUDA
# inputs: flash f32 sums in another order (2e-5, as the CPU parity tests
# against the Pallas kernel); bf16 outputs at most one bf16 ulp apart
# (< 0.8% of the value; atol 1e-3 only for values near 0); SSD f32 chunk
# sums and exp(cumulative log-decay) in another order
LM_TOL = {"f32": (2e-5, 2e-5), "bf16": (1e-2, 1e-3), "ssd": (1e-4, 1e-4)}
# prefill (kernels) against stepping the decode path (plain), f32 at full
# width, 4 blocks: max |difference| <= AGREE_TOL * max(1, max |logit|)
AGREE_TOL = 1e-3


def flash_cost(B, H, KV, Sq, Sk, hd, causal, window, itemsize):
    """(bytes, flops) the attention needs: q, k, v read once and the output
    written once; 4 * hd flops per visible (query, key) pair."""
    from repro_torch.kernels.flash_attention import visible_pairs
    nbytes = (2 * B * H * Sq * hd + 2 * B * KV * Sk * hd) * itemsize
    return nbytes, 4 * B * H * hd * visible_pairs(Sq, Sk, causal=causal,
                                                   window=window)


def ssd_cost(G, r, S, P, N, Q):
    """(bytes, flops) the SSD chunk scan needs: xdt, la, b, c read once and
    y written once (b, c per group, as the kernel reads them); per chunk,
    C B^T over the Q(Q+1)/2 causal pairs once per group (b and c are shared
    by the group's heads), and per head the decay mask (one multiply a
    pair), the intra term over the pairs, and the inter term and the state
    update, Q N P FMAs each; 2 flops per FMA."""
    BH, nC = G * r, S // Q
    nbytes = 4 * (2 * BH * S * P + BH * S + 2 * G * S * N)
    pairs = Q * (Q + 1) // 2
    return nbytes, (2 * G * nC * pairs * N
                    + BH * nC * (pairs + 2 * pairs * P + 4 * Q * N * P))


def lm_kernel_cases(torch) -> list:
    """Each LM kernel against its plain version at the prefill's shapes and
    the edge cases; returns one row per case."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain,
                                                     visible_mask)
    from repro_torch.kernels.ops import gqa_flash
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []

    def record(kernel, tag, dtype, shape, out, ref, fns, cost, peak, reps,
               cuda_core_peak=None):
        rtol, atol = LM_TOL[dtype]
        err = (out.float() - ref.float()).abs()
        ok = bool((err <= atol + rtol * ref.float().abs()).all())
        lib = fns[2]
        row = {"kernel": kernel, "case": tag, "dtype": dtype, "shape": shape,
               "max_abs_err": float(err.max()), "rtol": rtol, "atol": atol,
               "ok": ok,
               "kernel_ms": graph_ms(torch, fns[0], reps=reps, replays=3),
               "call_ms": call_ms(torch, fns[0], iters=reps, warmup=2),
               "plain_ms": graph_ms(torch, fns[1], reps=2, replays=2),
               "library_ms": None if lib is None else graph_ms(
                   torch, lib, reps=reps, replays=3),
               "bound_ms": bound_ms(*cost, peak),
               "bound_by": bound_by(*cost, peak), "bytes": cost[0],
               "flops": cost[1]}
        # the f32 flash kernel's bound before it ran on the tensor cores,
        # kept comparable with earlier runs
        core = ""
        if cuda_core_peak is not None:
            row["cuda_core_bound_ms"] = bound_ms(*cost, cuda_core_peak)
            core = f" cuda_core_bound_ms={row['cuda_core_bound_ms']:.5f}"
        lib_ms = row["library_ms"]
        ratio = None if lib_ms is None else row["kernel_ms"] / lib_ms
        print(f"[kernel] {kernel:15s} {tag:8s} {dtype:4s} {shape} "
              f"max_abs_err={row['max_abs_err']:.3e} tol=rtol {rtol:g}/atol "
              f"{atol:g} kernel_ms={row['kernel_ms']:.5f} call_ms="
              f"{row['call_ms']:.5f} plain_ms={row['plain_ms']:.5f} "
              f"library_ms={'null' if lib_ms is None else f'{lib_ms:.5f}'} "
              f"kernel/library={'null' if ratio is None else f'{ratio:.3f}'} "
              f"bound_ms={row['bound_ms']:.5f} ({row['bound_by']}){core} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"{kernel} {tag} {dtype} {shape} disagrees: "
                  f"{row['max_abs_err']}")
        rows.append(row)

    flash_cases = [  # tag, B, H, KV, Sq, Sk, hd, causal, window, dtypes
        ("hymba", 2, 25, 5, 4096, 4096, 64, True, 1024, ("bf16", "f32")),
        ("yi", 2, 32, 4, 2048, 2048, 128, True, 0, ("bf16",)),
        # arctic-480b's GQA: 56 q heads over 8 KV heads (G = 7)
        ("arctic", 2, 56, 8, 4096, 4096, 128, True, 0, ("bf16",)),
        ("ragged", 1, 4, 2, 1000, 1000, 64, True, 100, ("bf16", "f32")),
        ("cross", 2, 8, 2, 512, 1000, 64, False, 0, ("bf16", "f32")),
        ("nokey", 1, 2, 1, 200, 40, 64, True, 16, ("bf16", "f32")),
        # seamless-m4t-medium's prefill: the encoder's bidirectional
        # self-attention over 1024 frames, the decoder's causal
        # self-attention over 4096 text positions and its cross-attention
        # (4096 text positions over the 1024 encoder positions)
        ("seamless_encoder", 2, 16, 16, 1024, 1024, 64, False, 0,
         ("bf16", "f32")),
        ("seamless_decoder", 2, 16, 16, 4096, 4096, 64, True, 0,
         ("bf16", "f32")),
        ("seamless_cross", 2, 16, 16, 4096, 1024, 64, False, 0,
         ("bf16", "f32")),
        # seamless's training step (a client's 2 rows of 256 tokens): the
        # decoder's self- and cross-attention (its encoder is the row above)
        ("seamless_train_self", 2, 16, 16, 256, 256, 64, True, 0,
         ("bf16", "f32")),
        ("seamless_train_cross", 2, 16, 16, 256, 1024, 64, False, 0,
         ("bf16", "f32")),
        # llava-next-34b: G = 7 over 2880 patches + 1024 text tokens, the
        # last q tile ragged (3904 = 30 x 128 + 64)
        ("llava", 2, 56, 8, 3904, 3904, 128, True, 0, ("bf16", "f32")),
        # hymba-1.5b's training block: 8 rows of 256 tokens a client
        ("train_block", 8, 25, 5, 256, 256, 64, True, 1024, ("bf16", "f32")),
        # gqa_flash on the model's (B, S, H, hd) tensors, read through strides
        ("model", 2, 25, 5, 4096, 4096, 64, True, 1024, ("bf16",)),
    ]
    for tag, B, H, KV, Sq, Sk, hd, causal, window, dtypes in flash_cases:
        for dtype in dtypes:
            tdt = torch.bfloat16 if dtype == "bf16" else torch.float32

            def make(heads, S):
                if tag != "model":
                    return torch.randn((B, heads, S, hd), generator=gen,
                                       device="cuda").to(tdt)
                return torch.randn((B, S, heads, hd), generator=gen,
                                   device="cuda").to(tdt).transpose(1, 2)

            q, k, v = make(H, Sq), make(KV, Sk), make(KV, Sk)
            if tag == "model":
                qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))
                run = (lambda: gqa_flash(qs, ks, vs, causal=causal,
                                         window=window).transpose(1, 2))
            else:
                run = (lambda: flash_attention(q, k, v, causal=causal,
                                               window=window))
            out = run()
            check(out.shape == q.shape and out.dtype == tdt, "flash shape")
            check(out.stride() == q.stride(), "flash output not in q's layout")
            ref = flash_attention_plain(q, k, v, causal=causal, window=window)
            if tag == "nokey":
                check(bool((out[:, :, Sk + window - 1:] == 0).all()),
                      "a row with no visible key is not 0")
            mask = (visible_mask(Sq, Sk, causal, window, "cuda") if window
                    else None)
            lib = (lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, is_causal=causal and mask is None,
                enable_gqa=True))
            peak = (BF16_FLOPS_PER_S if dtype == "bf16"
                    else F32_FLASH_FLOPS_PER_S)
            record("flash_attention", tag, dtype,
                   f"B={B} H={H} KV={KV} Sq={Sq} Sk={Sk} hd={hd} "
                   f"causal={int(causal)} window={window}"
                   + (" (B,S,H,hd) views" if tag == "model" else ""), out, ref,
                   (run, lambda: flash_attention_plain(q, k, v, causal=causal,
                                                       window=window), lib),
                   flash_cost(B, H, KV, Sq, Sk, hd, causal, window,
                              q.element_size()), peak, reps=5,
                   cuda_core_peak=None if dtype == "bf16" else F32_FLOPS_PER_S)
            rows[-1]["problem"] = (B, H, KV, Sq, Sk, hd, causal, window)
            del q, k, v, out, ref

    # "model": hymba's xdt and la as (B, H, S, P) and (B, H, S) views of the
    # model's (B, S, H, P) and (B, S, H) tensors, read through strides, y
    # back in that layout, as ops.ssd_chunked_kernel hands them over;
    # "train_block": the same at hymba's training block (8 rows of 256)
    for tag, G, r, S, P, N, Q in (("hymba", 2, 64, 4096, 50, 16, 64),
                                  ("model", 2, 64, 4096, 50, 16, 64),
                                  ("mamba2", 2, 32, 4096, 64, 128, 64),
                                  ("train_block", 8, 64, 256, 50, 16, 64)):
        if tag in ("model", "train_block"):
            xdt = torch.randn((G, S, r, P), generator=gen,
                              device="cuda").transpose(1, 2)
            la = -0.5 * torch.rand((G, S, r), generator=gen,
                                   device="cuda").transpose(1, 2)
        else:
            xdt = torch.randn((G * r, S, P), generator=gen, device="cuda")
            la = -0.5 * torch.rand((G * r, S), generator=gen, device="cuda")
        b = 0.3 * torch.randn((G, S, N), generator=gen, device="cuda")
        c = 0.3 * torch.randn((G, S, N), generator=gen, device="cuda")
        y = ssd_scan(xdt, la, b, c, chunk=Q)
        again = ssd_scan(xdt, la, b, c, chunk=Q)
        check(y.shape == xdt.shape and y.stride() == xdt.stride(),
              "ssd output not in xdt's shape and layout")
        check(torch.equal(y, again), f"ssd_scan {tag}: two calls differ")
        record("ssd_scan", tag, "ssd",
               f"B={G} heads={r} S={S} P={P} N={N} Q={Q}"
               + (" (B,H,S,P) views" if tag != "hymba" and tag != "mamba2"
                  else ""), y,
               ssd_scan_plain(xdt, la, b, c, chunk=Q),
               (lambda: ssd_scan(xdt, la, b, c, chunk=Q),
                lambda: ssd_scan_plain(xdt, la, b, c, chunk=Q), None),
               ssd_cost(G, r, S, P, N, Q), F32_FLASH_FLOPS_PER_S, reps=5,
               cuda_core_peak=F32_FLOPS_PER_S)
        rows[-1]["bit_equal"] = True
        rows[-1]["device_ms"] = ssd_device_ms(torch, lambda: ssd_scan(
            xdt, la, b, c, chunk=Q))
        print(f"[kernel] ssd_scan        {tag:8s} device ms a call "
              f"(torch.profiler): {rows[-1]['device_ms']:.5f}; two calls "
              "bit-equal", flush=True)
    torch.cuda.empty_cache()
    return rows


def ssd_device_ms(torch, fn, calls: int = 5) -> float:
    """Device time a call of the SSD scan's one kernel (``ssd_scan_tc``, or
    ``ssd_scan_ws`` with a producer warpgroup), from ``torch.profiler``
    over ``calls`` calls; fails unless one such kernel, and no other, runs
    one launch a call."""
    fn()
    with device_profile(torch) as prof:
        for _ in range(calls):
            fn()
    mine = [e for e in device_kernels(prof) if "ssd_scan" in e.key]
    check(len(mine) == 1 and re.search(r"ssd_scan_(tc|ws)<", mine[0].key)
          and mine[0].count == calls,
          f"the SSD scan's kernels: {[(e.key, e.count) for e in mine]}")
    return mine[0].self_device_time_total / 1e3 / calls


def build_report() -> None:
    """ptxas's registers and spills of every kernel of the three libraries
    (the name with its mangled template arguments), and the count of
    tensor-core (``HGMMA``: the bf16 and the tf32 ones apart) and TMA-load
    (``UTMALDG``) instructions in the flash library's SASS and of tf32
    ``HGMMA`` s in the SSD library's. Fails unless both libraries' SASS
    holds tf32 ``HGMMA`` s (the f32 kernels on the tensor cores)."""
    from repro_torch.kernels import build
    for lib in build.SOURCES:
        report = build.ptxas_report(lib)
        kernel = None
        text = report.read_text() if report.is_file() else "no ptxas report"
        for line in text.splitlines():
            found = re.search(r"Compiling entry function '\w*?((?:fold|flash|"
                              r"ssd_scan)_[a-z0-9_]*?)((?:I|E)\w*)'", line)
            if found:   # the name and its mangled template arguments
                kernel = found[1] + (found[2].split("EEv")[0].split("Ev")[0]
                                     if found[2][0] == "I" else "")
            elif kernel and ("spill" in line or "registers" in line):
                print(f"[build] {lib}: {kernel}: {line.strip()}", flush=True)
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    check(Path(cuobjdump).exists(), "cuobjdump not found: no SASS to count")
    sass = subprocess.run([cuobjdump, "-sass",
                           str(build.library_path("flash_attention"))],
                          capture_output=True, text=True, timeout=120).stdout
    hgmma = [line for line in sass.splitlines() if "HGMMA" in line]
    tf32 = sum(".TF32" in line for line in hgmma)
    bf16 = sum(".BF16" in line for line in hgmma)
    print(f"[build] SASS of the flash library: HGMMA={len(hgmma)} (tf32 "
          f"{tf32}, bf16 {bf16}) UTMALDG={sass.count('UTMALDG')}", flush=True)
    check(tf32 > 0 and bf16 > 0,
          f"flash library SASS: {tf32} tf32 and {bf16} bf16 HGMMAs")
    sass = subprocess.run([cuobjdump, "-sass",
                           str(build.library_path("ssd_scan"))],
                          capture_output=True, text=True, timeout=120).stdout
    hgmma = [line for line in sass.splitlines() if "HGMMA" in line]
    tf32 = sum(".TF32" in line for line in hgmma)
    print(f"[build] SASS of the ssd library: HGMMA={len(hgmma)} (tf32 "
          f"{tf32})", flush=True)
    check(tf32 > 0, f"ssd library SASS: {tf32} tf32 HGMMAs")


def hymba_prefill(torch) -> dict:
    """The LM main path at full width and depth: hymba-1.5b's 32 blocks in
    bf16 over 2 x 4096 random prompt tokens through ``make_prefill_step``."""

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer as tr

    cfg = get_config("hymba-1.5b")
    B, S = 2, 4096
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = tr.init_params(gen, cfg, dtype=torch.bfloat16, device="cuda")
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen, device="cuda")
    torch.cuda.synchronize()
    n_params = tr.count_params(params)
    print(f"[hymba prefill] init {n_params} params (bf16) in "
          f"{time.perf_counter() - t0:.3f} s; L={cfg.L} d_model={cfg.d_model} "
          f"H={cfg.n_heads} KV={cfg.n_kv} hd={cfg.head_dim} window="
          f"{cfg.window} ssm heads={cfg.ssm_heads} P={cfg.ssm_head_dim} "
          f"N={cfg.ssm_state} chunk={cfg.ssm_chunk}", flush=True)
    step = make_prefill_step(cfg)
    step(params, tokens)                                 # warm-up
    torch.cuda.synchronize()
    flash_attention.launches = 0
    ssd_scan.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits = step(params, tokens)
    torch.cuda.synchronize()
    walls = [1e3 * (time.perf_counter() - t0)]
    launches = {"flash_attention": flash_attention.launches,
                "ssd_scan": ssd_scan.launches}
    check(tuple(logits.shape) == (B, cfg.padded_vocab),
          f"prefill logits shape {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "prefill logits not finite")
    check(launches == {"flash_attention": cfg.L, "ssd_scan": cfg.L},
          f"prefill launches {launches}, not {cfg.L} of each")
    for _ in range(2):
        t0 = time.perf_counter()
        step(params, tokens)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    wall = sorted(walls)[1]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[hymba prefill] B={B} S={S} logits={tuple(logits.shape)} finite "
          f"launches flash_attention={launches['flash_attention']} "
          f"ssd_scan={launches['ssd_scan']} wall_ms={[round(w, 3) for w in walls]}"
          f" median_wall_ms={wall:.3f} prefill_tok_per_s={B * S / wall * 1e3:.1f}"
          f" peak_mem_gb={peak_gb:.2f}", flush=True)

    with device_profile(torch, cpu=True) as prof:
        torch.cuda.synchronize()          # the spin kernels, outside t0
        t0 = time.perf_counter()
        step(params, tokens)
        torch.cuda.synchronize()
        prof_wall = 1e3 * (time.perf_counter() - t0)
    kernels = device_kernels(prof)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    # "flash_fwd_kernel" matches both flash kernels (_tc, _tf32);
    # "ssd_scan_" the SSD scan's kernel (ssd_scan_tc or ssd_scan_ws)
    mine = {name: sum(e.self_device_time_total for e in kernels
                      if key in e.key) / 1e3
            for name, key in (("flash_attention", "flash_fwd_kernel"),
                              ("ssd_scan", "ssd_scan_"))}
    ssd_launches = sum(e.count for e in kernels if "ssd_scan_" in e.key)
    copies = [e for e in kernels if "direct_copy" in e.key]
    n_copies = sum(e.count for e in copies)
    copy_ms = sum(e.self_device_time_total for e in copies) / 1e3
    print(f"[hymba profile] one prefill: wall_ms={prof_wall:.3f} "
          f"device_busy_ms={busy:.3f} idle_share={1 - busy / prof_wall:.4f} "
          f"flash_ms={mine['flash_attention']:.3f} ssd_ms={mine['ssd_scan']:.3f}"
          f" kernels_share_of_busy="
          f"{sum(mine.values()) / max(busy, 1e-9):.4f} ssd_kernel_launches="
          f"{ssd_launches} direct_copy launches={n_copies} ms={copy_ms:.3f}",
          flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"[hymba profile]   {e.self_device_time_total / 1e3:9.3f} ms "
              f"x{e.count:<5d} {e.key[:90]}", flush=True)
    check(busy > 0, "the profiler saw no device time")
    check(ssd_launches == cfg.L,
          f"{ssd_launches} SSD kernel launches, not one a block x {cfg.L}")
    arg_bytes = param_bytes(params) + tokens.nbytes
    del params, tokens, logits
    torch.cuda.empty_cache()
    return {"launches": launches, "wall_ms": wall, "kernel_ms": mine,
            "busy_ms": busy, "direct_copy_launches": n_copies,
            "tok_per_s": B * S / wall * 1e3,
            "idle_share": 1 - busy / prof_wall, "peak_gb": peak_gb,
            "card": {"arch": cfg.name, "B": B, "seq_len": S,
                     "front": "float32", "arg_bytes": arg_bytes}}


def hymba_serve(torch) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.launch.serve import serve

    flash_attention.launches = 0
    ssd_scan.launches = 0
    out = serve("hymba-1.5b", batch=4, prompt_len=64, new_tokens=32,
                reduced=False, device="cuda", verbose=False)
    gen = torch.tensor(out["generated"])
    V = get_config("hymba-1.5b").padded_vocab
    print(f"[hymba serve] batch=4 prompt_len=64 new_tokens=32 generated="
          f"{tuple(gen.shape)} prompt_s={out['prefill_s']:.3f} decode_s="
          f"{out['decode_s']:.3f} tok_per_s={out['tok_per_s']:.2f} "
          f"launches flash_attention={flash_attention.launches} ssd_scan="
          f"{ssd_scan.launches} (decode is plain, as in the reference) "
          f"sample={gen[0, :8].tolist()}", flush=True)
    check(tuple(gen.shape) == (4, 32), f"generated shape {tuple(gen.shape)}")
    check(bool(((gen >= 0) & (gen < V)).all()), "generated token out of range")
    check(math.isfinite(out["tok_per_s"]) and out["tok_per_s"] > 0,
          "serve throughput not finite")
    torch.cuda.empty_cache()
    return out


def hymba_agree(torch) -> float:
    """Prefill (the kernels) against stepping the decode path (plain) over
    the same 1152-token prompt, past the 1024-token window: full width, 4
    blocks, f32 with TF32 off."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer as tr

    cfg = dataclasses.replace(get_config("hymba-1.5b"), L=4, dtype="float32")
    B, S = 2, 1152
    gen = torch.Generator(device="cuda").manual_seed(3)
    params = tr.init_params(gen, cfg, device="cuda")
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen, device="cuda")
    pre = make_prefill_step(cfg)(params, tokens)
    cache = tr.init_cache(cfg, B, S, device="cuda")
    t0 = time.perf_counter()
    with torch.inference_mode():
        for pos in range(S):
            dec, cache = tr.decode_step(params, cfg, cache, tokens[:, pos], pos)
    torch.cuda.synchronize()
    err = float((pre - dec).abs().max())
    scale = max(1.0, float(dec.abs().max()))
    print(f"[hymba agree] L=4 f32 B={B} S={S} window={cfg.window} "
          f"max_abs_err={err:.3e} max_abs_logit={float(dec.abs().max()):.4f} "
          f"tol={AGREE_TOL:g}*max(1,max|logit|) decode_s="
          f"{time.perf_counter() - t0:.3f}", flush=True)
    check(bool(torch.isfinite(pre).all()), "agree: prefill logits not finite")
    check(err <= AGREE_TOL * scale,
          f"prefill and decode disagree past the window: {err}")
    del params, cache
    torch.cuda.empty_cache()
    return err


# ---------------------------------------------------------------------------
# LM training: both LM kernels under autograd, the fold kernels on the LM's
# stacked leaves
# ---------------------------------------------------------------------------

# (rtol, atol) of a Function's gradients against autograd through the plain
# version on the same CUDA inputs, atol scaled by max(1, max |grad|): flash
# f32 TOL["f32"]; flash bf16 twice TOL["bf16"] (both sides round the grads
# to bf16, and the kernel's O, which the backward reads, may be one bf16 ulp
# from the plain O); SSD f32 LM_TOL["ssd"] (the forward's own tolerance:
# the kernel's y feeds the loss's nonlinear term)
GRAD_TOL = {"f32": TOL["f32"], "bf16": tuple(2 * t for t in TOL["bf16"]),
            "ssd": LM_TOL["ssd"]}
# the training cell: hymba-1.5b at full width and depth, temporal backend
LM_TRAIN = dict(U=4, seq=256, s_max_cap=8, rounds=3, tmax=12.0,
                solver_steps=600, seed=0)
# dense against temporal, f32 compute: of the update's max. Under int8 a
# delta that differs in its last bits between the two layouts (another GEMM
# shape, another summation order) can round to the next code: one step of
# amax / 127 a client, so that round is held to U / 127
LM_AGREE = {None: 1e-4, "int8": LM_TRAIN["U"] / 127}


def lm_grad_cases(torch) -> list:
    """Each LM kernel's Function against autograd through its plain version
    at hymba-1.5b's training block shape, plain and under vmap over 4
    clients; returns one row per case."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.ops import gqa_flash
    from repro_torch.kernels.ssd_scan import SSDScan, ssd_scan, ssd_scan_plain

    cfg = get_config("hymba-1.5b")
    B, S = LM_TRAIN["s_max_cap"], LM_TRAIN["seq"]
    H, KV, hd, win = cfg.n_heads, cfg.n_kv, cfg.head_dim, cfg.window
    Hs, P, N, Q = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk
    gen = torch.Generator(device="cuda").manual_seed(5)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device="cuda")

    def nonlinear(y, w):
        y = y.float()
        return (y * w).sum() + 0.5 * (y * y).sum()

    rows = []
    for dtype in ("bf16", "f32"):
        tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
        w = randn(B, S, H, hd)

        def attn_loss(q, k, v):
            return nonlinear(gqa_flash(q, k, v, causal=True, window=win), w)

        def attn_plain(q, k, v):
            o = flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                                      v.transpose(1, 2), causal=True,
                                      window=win).transpose(1, 2)
            return nonlinear(o, w)

        def attn_args(n):
            lead = (n,) if n else ()
            return tuple(randn(*lead, B, S, h, hd).to(tdt)
                         for h in (H, KV, KV))

        rows += grad_case(torch, "flash_attention", dtype, flash_attention,
                          attn_loss, attn_plain, attn_args,
                          f"B={B} S={S} H={H} KV={KV} hd={hd} window={win} "
                          "(B,S,H,hd) views",
                          (*flash_cost(B, H, KV, S, S, hd, True, win,
                                       2 if dtype == "bf16" else 4),
                           BF16_FLOPS_PER_S if dtype == "bf16"
                           else F32_FLASH_FLOPS_PER_S))
    ws = randn(B, S, Hs, P)

    def scan_loss(xdt, la, b, c):
        return nonlinear(SSDScan.apply(xdt.transpose(1, 2),
                                       la.transpose(1, 2), b.contiguous(),
                                       c.contiguous(), Q).transpose(1, 2), ws)

    def scan_plain(xdt, la, b, c):
        return nonlinear(ssd_scan_plain(xdt.transpose(1, 2),
                                        la.transpose(1, 2), b.contiguous(),
                                        c.contiguous(),
                                        chunk=Q).transpose(1, 2), ws)

    def scan_args(n):
        lead = (n,) if n else ()
        la = -0.5 * torch.rand(lead + (B, S, Hs), generator=gen,
                               device="cuda")
        return (randn(*lead, B, S, Hs, P), la, randn(*lead, B, S, N,
                                                     scale=0.3),
                randn(*lead, B, S, N, scale=0.3))

    rows += grad_case(torch, "ssd_scan", "ssd", ssd_scan, scan_loss,
                      scan_plain, scan_args,
                      f"B={B} S={S} heads={Hs} P={P} N={N} Q={Q} "
                      "(B,S,H,P) views",
                      (*ssd_cost(B, Hs, S, P, N, Q), F32_FLASH_FLOPS_PER_S))
    torch.cuda.empty_cache()
    return rows


def grad_case(torch, kernel, dtype, counter, loss, plain, make_args,
              shape, cost) -> list:
    """``torch.func.grad`` of ``loss`` (through a Function) against that of
    ``plain`` on the same inputs, once and under vmap over 4 clients: the
    grads within GRAD_TOL[dtype], one kernel launch a call. ``cost`` is one
    client's forward's (bytes, flops, peak rate), for its kernel's bound."""
    rows = []
    for clients in (0, 4):
        tag = f"vmap{clients}" if clients else "one"
        args = make_args(clients)
        argnums = tuple(range(len(args)))
        fn = torch.func.grad(loss, argnums=argnums)
        ref_fn = torch.func.grad(plain, argnums=argnums)
        if clients:
            fn, ref_fn = torch.func.vmap(fn), torch.func.vmap(ref_fn)
        counter.launches = 0
        got = fn(*args)
        torch.cuda.synchronize()
        launches = counter.launches
        ref = ref_fn(*args)
        rtol, atol = GRAD_TOL[dtype]
        err, ok = 0.0, True
        for a, b in zip(got, ref):
            a, b = a.float(), b.float()
            scale = max(1.0, float(b.abs().max()))
            d = (a - b).abs()
            err = max(err, float(d.max()) / scale)
            ok &= bool((d <= atol * scale + rtol * b.abs()).all())
        finite = all(bool(torch.isfinite(a.float()).all()) for a in got)
        ms = call_ms(torch, lambda: fn(*args), iters=3, warmup=1)
        plain_ms = call_ms(torch, lambda: ref_fn(*args), iters=3, warmup=1)
        grad_dev, kernel_dev = grad_device_ms(
            torch, lambda: fn(*args),
            "flash_fwd_kernel" if kernel == "flash_attention" else "ssd_scan_")
        check(0 < kernel_dev < grad_dev,
              f"{kernel} {dtype} {tag}: device ms of the grad call "
              f"{grad_dev}, of its kernel {kernel_dev}")
        n = max(clients, 1)
        bound = bound_ms(n * cost[0], n * cost[1], cost[2])
        by = bound_by(n * cost[0], n * cost[1], cost[2])
        print(f"[lm grad] {kernel:15s} {dtype:4s} {tag:5s} {shape} "
              f"launches={launches} max_abs_err/max(1,max|grad|)={err:.3e} "
              f"tol=rtol {rtol:g}/atol {atol:g}x max(1,max|grad|) "
              f"grad_ms={ms:.3f} plain_grad_ms={plain_ms:.3f} device ms of "
              f"the grad call={grad_dev:.4f}, its kernel={kernel_dev:.4f} "
              f"(bound {bound:.4f}, {by}) "
              f"{'ok' if ok and finite else 'FAIL'}", flush=True)
        check(finite, f"{kernel} {dtype} {tag}: gradient not finite")
        check(ok, f"{kernel} {dtype} {tag}: gradient disagrees with the "
                  f"plain version's: {err}")
        check(launches == 1, f"{kernel} {dtype} {tag}: {launches} launches "
                             "for one call, not 1")
        rows.append({"kernel": kernel, "dtype": dtype, "case": tag,
                     "max_err": err, "grad_ms": ms, "plain_grad_ms": plain_ms,
                     "backward_device_ms": grad_dev - kernel_dev,
                     "kernel_device_ms": kernel_dev, "bound_ms": bound})
        del args, got, ref
    return rows


def grad_device_ms(torch, fn, kernel_key: str) -> tuple:
    """(device ms of every kernel one call of ``fn()`` launches, device ms
    of those whose name holds ``kernel_key``), from ``torch.profiler`` with
    device activity only (the backward's kernels are launched from autograd's
    device thread, outside any host range of the call), after one call
    unprofiled."""
    fn()
    with device_profile(torch) as prof:
        fn()
    kernels = device_kernels(prof)
    return (sum(e.self_device_time_total for e in kernels) / 1e3,
            sum(e.self_device_time_total for e in kernels
                if kernel_key in e.key) / 1e3)


def lm_counters() -> dict:
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    return {"flash_attention": flash_attention, "ssd_scan": ssd_scan,
            **fold_counters()}


def device_split(prof) -> dict:
    """A profile's device ms by kind of kernel (disjoint), and the launches
    of the LM and fold kernels."""
    kinds = {"flash_fwd": 0.0, "ssd_scan": 0.0, "fold": 0.0, "gemm": 0.0,
             "log_softmax": 0.0, "other": 0.0}
    counts = {"flash_fwd": 0, "ssd_scan": 0, "fold": 0}
    for e in device_kernels(prof):
        ms = e.self_device_time_total / 1e3
        if "flash_fwd_kernel" in e.key:
            kind = "flash_fwd"
        elif "ssd_scan_" in e.key:
            kind = "ssd_scan"
        elif "fold_grouped" in e.key or re.search(r"\bfold_kernel", e.key):
            kind = "fold"
        elif GEMM_NAME.search(e.key):
            kind = "gemm"
        elif "softmax" in e.key.lower():
            kind = "log_softmax"
        else:
            kind = "other"
        kinds[kind] += ms
        if kind in counts:
            counts[kind] += e.count
    top = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                  for e in device_kernels(prof)), reverse=True)[:12]
    return {"ms": kinds, "launches": counts, "top": top}


def round_clock(torch, counters: dict, profiled: int):
    """A tracer that times each round between the runtime's ``set_round``
    calls (at each round's start and after the last), synchronized, with
    the wrappers' counts at both ends; round ``profiled`` runs under
    ``torch.profiler`` (device activity only), whose start and stop fall
    outside its times."""
    from repro_torch import obs
    from torch.profiler import ProfilerActivity, profile

    class RoundClock(obs.NullTracer):
        def __init__(self):
            self.ends, self.starts, self.prof, self.done = [], [], None, None

        def set_round(self, t):
            torch.cuda.synchronize()
            self.ends.append((time.perf_counter(),
                              {k: c.launches for k, c in counters.items()}))
            if self.prof is not None:
                close_window(torch)
                t0 = time.perf_counter()
                self.prof.__exit__(None, None, None)
                self.done, self.prof = self.prof, None
                self.stop_s = time.perf_counter() - t0
            if t == profiled:
                self.prof = profile(activities=[ProfilerActivity.CUDA])
                self.prof.__enter__()
                open_window(torch)
                torch.cuda.synchronize()
            self.starts.append((time.perf_counter(),
                                {k: c.launches for k, c in counters.items()}))

    return RoundClock()


def lm_training(torch, grad_rows: list) -> dict:
    """``run_training`` on hymba-1.5b at full width and depth, temporal.
    Round 2 is profiled on the device only (the host events of a vmapped
    training round take minutes to read back); the plain backwards' device
    ms a round come from ``grad_rows`` (a block's grad call less its
    kernel, device time at this shape, for each of the round's client
    forwards)."""
    from repro_torch.configs import get_config
    from repro_torch.fl.tasks import make_lm_model
    from repro_torch.launch.train import run_training
    from repro_torch.tree import tree_leaves

    cfg = get_config("hymba-1.5b")
    U, R = LM_TRAIN["U"], LM_TRAIN["rounds"]
    counters = lm_counters()
    profiled = 2

    init = make_lm_model(cfg).init(torch.Generator().manual_seed(0), "cuda")
    n_params = sum(t.numel() for t in tree_leaves(init))
    sums = [float(t.sum(dtype=torch.float64)) for t in tree_leaves(init)]
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    clock = round_clock(torch, counters, profiled)
    t0 = time.perf_counter()
    params, hist = run_training(
        "hymba-1.5b", reduced=False, backend="temporal", U=U,
        seq=LM_TRAIN["seq"], s_max_cap=LM_TRAIN["s_max_cap"], rounds=R,
        tmax=LM_TRAIN["tmax"], solver_steps=LM_TRAIN["solver_steps"],
        seed=LM_TRAIN["seed"], eval_every=1, verbose=False, tracer=clock,
        init_params=init, device="cuda")
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    del init
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    spans = list(zip(clock.starts, clock.ends[1:]))
    walls = [1e3 * (b[0] - a[0]) for a, b in spans]
    per_round = [{k: b[1][k] - a[1][k] for k in counters} for a, b in spans]
    changed = sum(float(t.sum(dtype=torch.float64)) != v
                  for t, v in zip(tree_leaves(params), sums))
    finite = all(math.isfinite(v) for v in hist.train_loss + hist.accuracy)
    print(f"[lm train] hymba-1.5b full width: L={cfg.L} d_model="
          f"{cfg.d_model} params={n_params} (f32, compute {cfg.dtype}) "
          f"backend=temporal U={U} seq={LM_TRAIN['seq']} s_max_cap="
          f"{LM_TRAIN['s_max_cap']} rounds={hist.rounds} losses="
          f"{[round(v, 6) for v in hist.train_loss]} token_acc="
          f"{[round(v, 6) for v in hist.accuracy]} leaves_changed={changed}/"
          f"{len(sums)} run_s={total_s:.3f} (solve and data included) "
          f"round_wall_ms={[round(w, 3) for w in walls]} (round "
          f"{profiled} profiled) peak_mem_gb={peak_gb:.2f}", flush=True)
    for t, launch in enumerate(per_round, 1):
        print(f"[lm train] round {t} launches "
              + " ".join(f"{k}={v}" for k, v in launch.items()), flush=True)
    check(len(hist.rounds) == R, f"trained {hist.rounds}, not {R} rounds")
    check(finite, f"losses or accuracies not finite: {hist.train_loss}")
    # a leaf whose layers drew no contributor in any round keeps its values
    check(changed > 0, "no param leaf changed")
    per_forward = cfg.L * (U + 1)       # U clients' forwards, one eval
    for launch in per_round:
        check(launch["flash_attention"] == per_forward
              and launch["ssd_scan"] == per_forward,
              f"LM kernel launches a round {launch}, not {per_forward} each "
              f"({cfg.L} a forward, {U} clients and one eval)")
        check(launch["adel_agg_grouped"] == U,
              f"{launch['adel_agg_grouped']} grouped folds a round, not {U}")
        others = {k: v for k, v in launch.items()
                  if k not in ("flash_attention", "ssd_scan",
                               "adel_agg_grouped")}
        check(not any(others.values()), f"another fold ran: {others}")
    t1 = time.perf_counter()
    split = device_split(clock.done)
    print(f"[lm train] profiler: stop {clock.stop_s:.3f} s, reading "
          f"{time.perf_counter() - t1:.3f} s", flush=True)
    busy = sum(split["ms"].values())
    wall = walls[profiled - 1]
    # the plain backwards a round: one per block a client forward (a grad
    # call's device ms less its kernel's: the loss's few elementwise ops
    # count as backward)
    backward = {r["kernel"]: cfg.L * U * r["backward_device_ms"]
                for r in grad_rows if r["case"] == "one"
                and r["dtype"] in ("bf16", "ssd")}
    print(f"[lm train] round {profiled} profile: wall_ms={wall:.3f} "
          f"device_busy_ms={busy:.3f} idle_share={1 - busy / wall:.4f} "
          "device ms by kind: " + " ".join(f"{k}={v:.3f}" for k, v in
                                            split["ms"].items())
          + f" share of busy: gemm={split['ms']['gemm'] / busy:.4f} "
          f"log_softmax={split['ms']['log_softmax'] / busy:.4f} "
          "plain backward device ms a round (a block's grad call less its "
          f"kernel, device time, x {cfg.L * U}): " + " ".join(
              f"{k}={v:.3f} ({v / busy:.4f} of busy)"
              for k, v in backward.items())
          + " kernel launches: " + " ".join(
              f"{k}={v}" for k, v in split["launches"].items()), flush=True)
    for ms, count, key in split["top"]:
        print(f"[lm train]   {ms:9.3f} ms x{count:<6d} {key[:90]}", flush=True)
    check(split["launches"]["flash_fwd"] == per_forward
          and split["launches"]["fold"] == U
          and split["launches"]["ssd_scan"] == per_forward,
          f"profiled launches {split['launches']}: not {per_forward} flash, "
          f"{per_forward} SSD kernels, {U} folds")
    del params
    torch.cuda.empty_cache()
    return {"launches_per_round": per_round[-1], "walls_ms": walls,
            "peak_gb": peak_gb, "split": split, "idle_share": 1 - busy / wall,
            "plain_backward_ms": backward}


def lm_dense_vs_temporal(torch) -> dict:
    """One round of dense and of temporal from the same params, batches and
    mask at full width cut to 4 blocks, f32 compute (TF32 off, so the
    layouts differ only in summation order), uncompressed and int8."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.fl.backends import make_backend
    from repro_torch.fl.spec import ExecSpec
    from repro_torch.fl.tasks import make_lm_model
    from repro_torch.tree import tree_leaves

    cfg = dataclasses.replace(get_config("hymba-1.5b"), L=4, dtype="float32")
    model = make_lm_model(cfg)
    params = model.init(torch.Generator().manual_seed(1), "cuda")
    U, b, seq = LM_TRAIN["U"], LM_TRAIN["s_max_cap"], LM_TRAIN["seq"]
    gen = torch.Generator(device="cuda").manual_seed(6)
    xb = torch.randint(0, min(2048, cfg.vocab), (U, b, seq + 1), generator=gen,
                       device="cuda", dtype=torch.int32)
    yb = torch.zeros((U, b), dtype=torch.int32, device="cuda")
    wb = torch.full((U, b), 1.0 / b, device="cuda")
    mask = torch.ones((U, cfg.n_blocks_total), device="cuda")
    mask[1, 0] = 0.0
    mask[3, 2:] = 0.0
    p = torch.full((cfg.n_blocks_total,), 0.1, device="cuda")
    counters = fold_counters()
    out = {}
    for comp in (None, "int8"):
        rounds = {}
        for bk in ("dense", "temporal"):
            for c in counters.values():
                c.launches = 0
            backend = make_backend(exec=ExecSpec(backend=bk, compression=comp),
                                   model=model, device="cuda")
            t0 = time.perf_counter()
            rounds[bk] = backend.run_round(params, xb, yb, wb, mask, p, 0.5,
                                           bias_correct=True)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            fired = {k: c.launches for k, c in counters.items()}
            name = "adel_agg_grouped" if comp is None else "adel_agg_q8_grouped"
            want = 1 if bk == "dense" else U
            print(f"[lm backends] L=4 full width f32 {comp or 'none'} {bk}: "
                  f"wall_ms={ms:.3f} launches "
                  + " ".join(f"{k}={v}" for k, v in fired.items()), flush=True)
            check(fired.pop(name) == want,
                  f"{bk} {comp}: not {want} {name} launches")
            check(not any(fired.values()), f"{bk} {comp}: another fold ran")
            out[(comp or "none", bk)] = want
        leaves = list(zip(tree_leaves(rounds["temporal"]),
                          tree_leaves(rounds["dense"]), tree_leaves(params)))
        upd = max(float((d - w).abs().max()) for _, d, w in leaves)
        err = max(float((t - d).abs().max()) for t, d, _ in leaves) / upd
        print(f"[lm backends] L=4 {comp or 'none'}: max|temporal - dense| / "
              f"max|dense update| = {err:.3e} (tol {LM_AGREE[comp]:g}) "
              f"max|update|={upd:.4e}", flush=True)
        check(upd > 0, "the dense LM round did not move the params")
        check(err <= LM_AGREE[comp],
              f"temporal and dense disagree on the LM: {err}")
        del rounds
    del params
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# MoE and MLA: deepseek-v2-lite-16b whole on the card, arctic-480b at full
# width through flash attention
# ---------------------------------------------------------------------------

# the two MoE cells and their cuts: deepseek-v2-lite-16b at full width and
# depth (27 blocks) for the prefill and serve; arctic-480b at full width cut
# to 2 of 35 blocks (one block is 13.6 B params); the training cell is
# deepseek cut to 2 of 27 blocks in f32, 3 rounds
MOE_PREFILL = dict(B=2, S=4096)
MOE_SERVE = dict(B=4, prompt=64, new=32)
ARCTIC_BLOCKS = 2
MOE_TRAIN = dict(LM_TRAIN, layers=2)
# prefill at capacity_factor = n_experts against the decode path (dropless
# in the reference and the port): 2 x 64 tokens, 2 blocks at full width.
# deepseek in f32 (TF32 off): the last position's logits within AGREE_TOL.
# arctic in bf16 (2 blocks are 55.4 GB, f32 would be 110.8 GB): bf16
# rounds the two paths apart by about one ulp a value, and where a token's
# router sits at a near-tie that moves it to another expert (O(1) on its
# logits); so each position's logits within MOE_AGREE_BF16 * max(1, max
# |logit|) at no fewer than MOE_AGREE_SHARE of the positions
MOE_AGREE_S = 64
MOE_AGREE_BF16 = 5e-2
MOE_AGREE_SHARE = 0.9
OP_KINDS = ("expert_gemm", "dispatch_combine", "router", "moe_other",
            "mla_attention", "flash_attention", "gemm", "other")
GEMM_NAME = re.compile(r"gemm|nvjet|xmma|cutlass", re.I)


def own_kernels(e) -> list:
    """The kernels the profiler hangs on host op ``e`` and on none of the
    ops under it: it hangs some on a composite op and on the op that
    implements it alike (``aten::softmax`` and ``aten::_softmax``)."""
    below: dict = {}
    todo = list(e.cpu_children)
    while todo:
        c = todo.pop()
        for k in c.kernels:
            below[(k.name, k.duration)] = below.get((k.name, k.duration),
                                                    0) + 1
        todo.extend(c.cpu_children)
    own = []
    for k in e.kernels:
        if below.get((k.name, k.duration), 0):
            below[(k.name, k.duration)] -= 1
        else:
            own.append(k)
    return own


def op_split(prof) -> dict:
    """Device ms of a profile by kind, from the host op that launched each
    kernel and the Python functions it ran under (the profiler's
    ``with_stack`` records them as the op's ancestors and its stack): in
    ``router_topk`` the router (``router``); in ``moe_ffn`` the experts'
    batched products (``expert_gemm``), the index ops of dispatch and
    combine (``dispatch_combine``: one-hot, cumsum, gather, index_put,
    index_select, the sum over a token's assignments) and the elementwise
    rest (``moe_other``: the SiLU gate, the router weighting); in
    ``mla_prefill`` everything but its projections (``mla_attention``:
    rope, the score and PV products, mask, softmax); the flash kernel
    (``flash_attention``); elsewhere the GEMMs (``gemm``: projections,
    shared and dense FFNs, the head: a product op's kernels, or a kernel
    named as a GEMM where the profiler hung it on another op, as it did
    with most of llava-next-34b's) and the rest. Kernels count once, at
    the innermost op that holds them (``own_kernels``), and not on a
    Python call (``python_ms`` says how much the profiler hung there).
    None (with a line saying what the profile held) when it recorded no
    Python functions."""
    from torch.autograd import DeviceType
    ms = dict.fromkeys(OP_KINDS, 0.0)
    python, launching, sample, python_ms = False, 0, "", 0.0
    index = re.compile(r"index|cumsum|gather|scatter|cat|where|eq|sum|"
                       r"zeros|fill|copy|expand|clone|sub|lt|full|arange")
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            continue
        kernels = [k for k in own_kernels(e) if "spin_kernel" not in k.name]
        if not kernels:
            continue
        if ".py(" in e.name or e.name.startswith("<built-in"):
            python_ms += sum(k.duration for k in kernels) / 1e3
            continue
        names, up = list(e.stack or ()), e
        while up is not None:
            names.append(up.name)
            up = up.cpu_parent
        chain = " ".join(names)
        python |= ".py(" in chain
        launching += 1
        sample = sample or chain[:300]
        gemm = e.name in ("aten::mm", "aten::addmm", "aten::bmm")
        if "router_topk" in chain:
            kind = "router"
        elif "moe_ffn" in chain:
            kind = ("expert_gemm" if e.name == "aten::bmm"
                    else "dispatch_combine" if index.search(e.name)
                    else "moe_other")
        elif "mla_prefill" in chain:
            kind = ("gemm" if gemm and "aten::einsum" not in chain
                    else "mla_attention")
        else:
            kind = "gemm" if gemm else "other"
        for k in kernels:
            ms["flash_attention" if "flash_fwd" in k.name
               else "gemm" if kind == "other" and GEMM_NAME.search(k.name)
               else kind] += k.duration / 1e3
    if not python:
        print(f"[op split] no Python frames: {launching} host ops launched "
              f"kernels; one op's ancestry: {sample!r}", flush=True)
        return None
    ms["python_ms"] = python_ms
    return ms


def prefill_phase(torch, tag: str, cfg, params, B: int = MOE_PREFILL["B"],
                  S: int = MOE_PREFILL["S"]) -> dict:
    """``make_prefill_step`` over B x S random tokens (and, for a config
    with a frontend, B x n_frontend_tokens patch or frame embeddings of
    0.02 N(0, 1)): finite logits, wall (median of 3 after a warm-up),
    tokens/s (over every position the model reads, and over the text
    alone), peak memory, the LM kernels' launches by their wrappers, then
    one prefill under ``torch.profiler`` (host and device): idle share,
    device ms by kind (``op_split``) and the flash kernel's launches as
    the profiler counts them."""
    from repro_torch.launch.steps import make_prefill_step
    gen = torch.Generator(device="cuda").manual_seed(7)
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen, device="cuda")
    n_front = cfg.n_frontend_tokens if cfg.frontend != "none" else 0
    extra = (() if not n_front else (0.02 * torch.randn(
        (B, n_front, cfg.d_model), generator=gen, device="cuda"),))
    step = make_prefill_step(cfg)
    counters = lm_counters()
    step(params, tokens, *extra)                         # warm-up
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    counters["flash_attention"].shapes.clear()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits = step(params, tokens, *extra)
    torch.cuda.synchronize()
    walls = [1e3 * (time.perf_counter() - t0)]
    launches = {k: c.launches for k, c in counters.items()}
    flash_shapes = dict(counters["flash_attention"].shapes)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(tuple(logits.shape) == (B, cfg.padded_vocab),
          f"{tag}: prefill logits shape {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), f"{tag}: logits not finite")
    for _ in range(2):
        t0 = time.perf_counter()
        step(params, tokens, *extra)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    wall = sorted(walls)[1]
    read = B * (S + n_front)
    print(f"[{tag} prefill] B={B} S={S}"
          + (f" + {n_front} {cfg.frontend} frontend positions" if n_front
             else "") + f" logits={tuple(logits.shape)} finite "
          "launches " + " ".join(f"{k}={v}" for k, v in launches.items())
          + f" wall_ms={[round(w, 3) for w in walls]} median_wall_ms="
          f"{wall:.3f} prefill_tok_per_s={read / wall * 1e3:.1f}"
          + (f" text_tok_per_s={B * S / wall * 1e3:.1f}" if n_front else "")
          + f" peak_mem_gb={peak_gb:.2f}", flush=True)
    with device_profile(torch, cpu=True, stack=True) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(params, tokens, *extra)
        torch.cuda.synchronize()
        prof_wall = 1e3 * (time.perf_counter() - t0)
    kernels = device_kernels(prof)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    flash = sum(e.count for e in kernels if "flash_fwd_kernel" in e.key)
    split = op_split(prof)
    print(f"[{tag} profile] one prefill: wall_ms={prof_wall:.3f} "
          f"device_busy_ms={busy:.3f} idle_share={1 - busy / prof_wall:.4f} "
          f"flash_fwd launches={flash} device ms by kind: "
          + ("not measured (no stacks)" if split is None
             else " ".join(f"{k}={split[k]:.3f} ({split[k] / busy:.4f})"
                           for k in OP_KINDS)
             + f" sum={sum(split[k] for k in OP_KINDS):.3f} (kernels also "
             f"hung on Python calls, not counted: {split['python_ms']:.3f})"),
          flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"[{tag} profile]   {e.self_device_time_total / 1e3:9.3f} ms "
              f"x{e.count:<5d} {e.key[:90]}", flush=True)
    check(busy > 0, f"{tag}: the profiler saw no device time")
    arg_bytes = (param_bytes(params) + tokens.nbytes
                 + sum(t.nbytes for t in extra))
    del tokens, logits, extra
    return {"launches": launches, "flash_shapes": flash_shapes,
            "wall_ms": wall, "peak_gb": peak_gb,
            # the dry run's shape: a vision prefill's seq_len counts the
            # patches too (launch/specs.py:text_len)
            "card": {"arch": cfg.name, "B": B, "seq_len": S + (
                n_front if cfg.frontend == "vision" else 0),
                "front": "float32", "arg_bytes": arg_bytes},
            "tok_per_s": read / wall * 1e3,
            "text_tok_per_s": B * S / wall * 1e3, "busy_ms": busy,
            "idle_share": 1 - busy / prof_wall, "flash_profiled": flash,
            "split": split}


def param_bytes(params) -> int:
    """Bytes of a param tree as it lies on the card."""
    from repro_torch.tree import tree_leaves
    return sum(t.nbytes for t in tree_leaves(params))


def init_bf16(torch, tag: str, cfg, seed: int):
    from repro_torch.models import transformer as tr
    t0 = time.perf_counter()
    params = tr.init_params(torch.Generator(device="cuda").manual_seed(seed),
                            cfg, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    n = tr.count_params(params)
    print(f"[{tag} prefill] init {n} params (bf16, {2 * n / 1e9:.2f} GB; "
          f"the config's count without the final norm: {cfg.param_count()}) "
          f"in {time.perf_counter() - t0:.3f} s; L={cfg.L} d_model="
          f"{cfg.d_model} attention={cfg.attention} H={cfg.n_heads} KV="
          f"{cfg.n_kv} experts={cfg.n_experts} top_k={cfg.top_k} shared="
          f"{cfg.n_shared} expert_d_ff={cfg.expert_d_ff} dense_residual="
          f"{int(cfg.dense_residual)} kv_lora={cfg.kv_lora} peak_mem_gb="
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f}", flush=True)
    return params


def deepseek_serve(torch, cfg, params) -> dict:
    """Greedy serving through ``make_serve_step`` at full width and depth:
    bf16 params, f32 latent cache, the prompt stepped through the decode
    path, then ``new`` tokens (as ``launch/serve.py:serve`` does, which
    draws f32 params: 64.8 GB)."""
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import transformer as tr
    B, P, N = MOE_SERVE["B"], MOE_SERVE["prompt"], MOE_SERVE["new"]
    gen = torch.Generator(device="cuda").manual_seed(8)
    prompts = torch.randint(0, cfg.vocab, (B, P), generator=gen, device="cuda")
    cache = tr.init_cache(cfg, B, P + N + 1, dtype=torch.float32,
                          device="cuda")
    step = make_serve_step(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for i in range(P - 1):
        _, cache = step(params, cache, prompts[:, i], i)
    torch.cuda.synchronize()
    prompt_s = time.perf_counter() - t0
    tok, out = prompts[:, -1], []
    t0 = time.perf_counter()
    for j in range(N):
        tok, cache = step(params, cache, tok, P - 1 + j)
        out.append(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    gen_tokens = torch.stack(out, dim=1).cpu()
    tps = B * N / decode_s
    with device_profile(torch) as prof:           # one more step, profiled
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(params, cache, tok, P + N - 1)
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0)
    busy = sum(e.self_device_time_total for e in device_kernels(prof)) / 1e3
    launched = sum(e.count for e in device_kernels(prof))
    print(f"[deepseek serve] one decode step profiled: wall_ms={step_ms:.3f} "
          f"device_busy_ms={busy:.3f} idle_share={1 - busy / step_ms:.4f} "
          f"kernels={launched}", flush=True)
    print(f"[deepseek serve] batch={B} prompt_len={P} new_tokens={N} "
          f"generated={tuple(gen_tokens.shape)} prompt_s={prompt_s:.3f} "
          f"decode_s={decode_s:.3f} decode_tok_per_s={tps:.2f} ms_a_step="
          f"{1e3 * decode_s / N:.3f} peak_mem_gb="
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} (latent cache f32, "
          f"MLA decode and the dropless MoE plain, as in the reference) "
          f"sample={gen_tokens[0, :8].tolist()}", flush=True)
    check(tuple(gen_tokens.shape) == (B, N), "serve: generated shape")
    check(bool(((gen_tokens >= 0) & (gen_tokens < cfg.padded_vocab)).all()),
          "serve: generated token out of range")
    del cache
    return {"tok_per_s": tps, "ms_a_step": 1e3 * decode_s / N,
            "idle_share": 1 - busy / step_ms}


def moe_agree(torch, tag: str, cfg, params, cache_dtype) -> float:
    """The prefill at ``capacity_factor = n_experts`` (the kernels) against
    stepping the decode path (dropless, plain) over the same 2 x 64 tokens:
    every position's logits. Returns the largest error over max(1, max
    |logit|) of the positions checked."""
    import dataclasses

    from repro_torch.models import transformer as tr
    B, S = 2, MOE_AGREE_S
    dropless = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    gen = torch.Generator(device="cuda").manual_seed(9)
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen, device="cuda")
    with torch.inference_mode():
        full = tr.forward(params, dropless, tokens).float()
        cache = tr.init_cache(cfg, B, S, dtype=cache_dtype, device="cuda")
        errs = []
        for pos in range(S):
            dec, cache = tr.decode_step(params, cfg, cache, tokens[:, pos],
                                        pos)
            scale = max(1.0, float(dec.abs().max()))
            errs.append(float((full[:, pos] - dec).abs().max()) / scale)
    torch.cuda.synchronize()
    f32 = cfg.dtype == "float32"
    tol = AGREE_TOL if f32 else MOE_AGREE_BF16
    within = sum(e <= tol for e in errs) / S
    print(f"[moe agree] {tag} L={cfg.L} {cfg.dtype} B={B} S={S} "
          f"capacity_factor={dropless.capacity_factor:g} (prefill) vs "
          f"dropless decode: last position err/max(1,max|logit|)="
          f"{errs[-1]:.3e} max over positions={max(errs):.3e} positions "
          f"within tol={within:.4f} tol={tol:g} "
          + ("(last position)" if f32 else
             f"(at least {MOE_AGREE_SHARE:g} of the positions)"), flush=True)
    check(bool(torch.isfinite(full).all()), f"agree {tag}: logits not finite")
    if f32:
        check(errs[-1] <= tol, f"agree {tag}: prefill and decode disagree: "
                                f"{errs[-1]}")
    else:
        check(within >= MOE_AGREE_SHARE,
              f"agree {tag}: {within:.3f} of the positions within {tol}")
    del cache, full
    return errs[-1] if f32 else max(errs)


def moe_models(torch) -> dict:
    """deepseek-v2-lite-16b whole (prefill, profile, serve), then arctic-480b
    at 2 blocks (prefill, profile, agree), then deepseek at 2 blocks in f32
    (agree); each model's params are freed before the next is drawn."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tr
    out = {}
    cfg = get_config("deepseek-v2-lite-16b")
    torch.cuda.reset_peak_memory_stats()
    params = init_bf16(torch, "deepseek", cfg, 0)
    out["deepseek_prefill"] = prefill_phase(torch, "deepseek", cfg, params)
    launches = out["deepseek_prefill"]["launches"]
    check(not any(launches.values()),
          f"deepseek prefill launched an LM kernel: {launches} (MLA is plain)")
    out["deepseek_serve"] = deepseek_serve(torch, cfg, params)
    del params
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(get_config("arctic-480b"), L=ARCTIC_BLOCKS)
    torch.cuda.reset_peak_memory_stats()
    params = init_bf16(torch, "arctic", cfg, 1)
    pre = prefill_phase(torch, "arctic", cfg, params)
    out["arctic_prefill"] = pre
    check(pre["launches"]["flash_attention"] == cfg.L
          and pre["flash_profiled"] == cfg.L,
          f"arctic prefill: flash launches {pre['launches']} (wrapper), "
          f"{pre['flash_profiled']} (profiler), not {cfg.L}")
    others = {k: v for k, v in pre["launches"].items()
              if k != "flash_attention"}
    check(not any(others.values()), f"arctic prefill: another kernel {others}")
    out["arctic_agree"] = moe_agree(torch, "arctic-480b", cfg, params,
                                    torch.bfloat16)
    del params
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(get_config("deepseek-v2-lite-16b"), L=2,
                              dtype="float32")
    params = tr.init_params(torch.Generator(device="cuda").manual_seed(2),
                            cfg, device="cuda")
    out["deepseek_agree"] = moe_agree(torch, "deepseek-v2-lite-16b", cfg,
                                      params, torch.float32)
    del params
    torch.cuda.empty_cache()
    return out


def moe_fold_case(torch, params, ids) -> dict:
    """One temporal client's fold on the deepseek training cell's leaves
    (2 blocks at full width, f32: the (L, E*D*F) expert leaves among them):
    ``adel_agg_grouped`` at U=1 against its plain version on random grads
    with the leaves' shapes and layer ids, as ``_fold_one`` hands them over;
    timed with the bytes bound, beside one ``torch.einsum`` a leaf (a
    yardstick the port never calls, as the VGG-11 fold's)."""
    from repro_torch.kernels.adel_agg import (adel_agg_grouped,
                                              adel_agg_grouped_plain,
                                              leaf_coeff_rows)
    from repro_torch.kernels.ops import leaf_dims
    from repro_torch.tree import tree_leaves
    gen = torch.Generator(device="cuda").manual_seed(10)
    leaves = [torch.randn((1, *leaf_dims(t.shape, i)), generator=gen,
                          device="cuda")
              for t, i in zip(tree_leaves(params), tree_leaves(ids))]
    id_list = tree_leaves(ids)
    coeff = torch.rand((1, 2), generator=gen, device="cuda")
    out = adel_agg_grouped(leaves, id_list, coeff)
    ref = adel_agg_grouped_plain(leaves, id_list, coeff)
    rtol, atol = TOL["f32"]
    err = max(float((a - b).abs().max()) for a, b in zip(out, ref))
    ok = all(bool(((a - b).abs() <= atol + rtol * b.abs()).all())
             for a, b in zip(out, ref))
    n = sum(t.numel() for t in leaves)
    nbytes = 2 * 4 * n + 4 * coeff.numel()
    ms = call_ms(torch, lambda: adel_agg_grouped(leaves, id_list, coeff),
                 iters=5, warmup=1)
    plain_ms = call_ms(torch, lambda: adel_agg_grouped_plain(
        leaves, id_list, coeff), iters=3, warmup=1)
    rows = [leaf_coeff_rows(coeff, i) for i in id_list]
    library_ms = call_ms(torch, lambda: [
        torch.einsum("ul,ulf->lf", c, g) for g, c in zip(leaves, rows)],
        iters=5, warmup=1)
    biggest = max(leaves, key=lambda t: t.numel())
    row = {"leaves": len(leaves), "values": n, "largest_leaf":
           tuple(biggest.shape[1:]), "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms(nbytes, 2 * n),
           "bound_by": bound_by(nbytes, 2 * n)}
    print(f"[moe train] one client's fold (U=1, f32): {row['leaves']} leaves, "
          f"{n} values, largest (rows, F)={row['largest_leaf']} "
          f"max_abs_err={err:.3e} tol=rtol {rtol:g}/atol {atol:g} "
          f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms="
          f"{library_ms:.4f} ({len(leaves)} torch.einsum) bound_ms="
          f"{row['bound_ms']:.4f} ({row['bound_by']}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    check(ok, f"the MoE cell's fold disagrees with plain: {err}")
    del leaves, out, ref
    torch.cuda.empty_cache()
    return row


def moe_training(torch) -> dict:
    """``run_training("deepseek-v2-lite-16b", reduced=False, layers=2)``:
    full width cut to 2 of 27 blocks, f32 params, bf16 compute, temporal,
    U=4, 256-token rows, at most 8 a client, 3 rounds, ADEL. Finite losses,
    every leaf changed, one grouped fold a client a round and no other
    kernel of the port (wrappers a round; round 2 under ``torch.profiler``,
    device activity), wall a round, peak memory, idle share; then one
    client's fold on these leaves against its plain version."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.fl.tasks import make_lm_model
    from repro_torch.launch.train import run_training
    from repro_torch.models import transformer as tr
    from repro_torch.tree import tree_leaves

    cfg = dataclasses.replace(get_config("deepseek-v2-lite-16b"),
                              L=MOE_TRAIN["layers"])
    U, R = MOE_TRAIN["U"], MOE_TRAIN["rounds"]
    counters = lm_counters()
    profiled = 2
    init = make_lm_model(cfg).init(torch.Generator().manual_seed(0), "cuda")
    n_params = sum(t.numel() for t in tree_leaves(init))
    sums = [float(t.sum(dtype=torch.float64)) for t in tree_leaves(init)]
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    clock = round_clock(torch, counters, profiled)
    t0 = time.perf_counter()
    params, hist = run_training(
        "deepseek-v2-lite-16b", reduced=False, layers=MOE_TRAIN["layers"],
        backend="temporal", U=U, seq=MOE_TRAIN["seq"],
        s_max_cap=MOE_TRAIN["s_max_cap"], rounds=R, tmax=MOE_TRAIN["tmax"],
        solver_steps=MOE_TRAIN["solver_steps"], seed=MOE_TRAIN["seed"],
        eval_every=1, verbose=False, tracer=clock, init_params=init,
        device="cuda")
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    del init
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    spans = list(zip(clock.starts, clock.ends[1:]))
    walls = [1e3 * (b[0] - a[0]) for a, b in spans]
    per_round = [{k: b[1][k] - a[1][k] for k in counters} for a, b in spans]
    changed = sum(float(t.sum(dtype=torch.float64)) != v
                  for t, v in zip(tree_leaves(params), sums))
    finite = all(math.isfinite(v) for v in hist.train_loss + hist.accuracy)
    print(f"[moe train] deepseek-v2-lite-16b full width, {cfg.L} of 27 "
          f"blocks: params={n_params} (f32, {4 * n_params / 1e9:.2f} GB, "
          f"compute {cfg.dtype}) backend=temporal U={U} seq="
          f"{MOE_TRAIN['seq']} s_max_cap={MOE_TRAIN['s_max_cap']} rounds="
          f"{hist.rounds} losses={[round(v, 6) for v in hist.train_loss]} "
          f"token_acc={[round(v, 6) for v in hist.accuracy]} leaves_changed="
          f"{changed}/{len(sums)} run_s={total_s:.3f} (solve and data "
          f"included) round_wall_ms={[round(w, 3) for w in walls]} (round "
          f"{profiled} profiled) peak_mem_gb={peak_gb:.2f}", flush=True)
    for t, launch in enumerate(per_round, 1):
        print(f"[moe train] round {t} launches "
              + " ".join(f"{k}={v}" for k, v in launch.items()), flush=True)
    check(len(hist.rounds) == R, f"trained {hist.rounds}, not {R} rounds")
    check(finite, f"losses or accuracies not finite: {hist.train_loss}")
    check(changed == len(sums), f"{len(sums) - changed} leaves unchanged")
    for launch in per_round:
        check(launch["adel_agg_grouped"] == U,
              f"{launch['adel_agg_grouped']} grouped folds a round, not {U}")
        others = {k: v for k, v in launch.items() if k != "adel_agg_grouped"}
        check(not any(others.values()), f"another kernel ran: {others}")
    split = device_split(clock.done)
    busy = sum(split["ms"].values())
    wall = walls[profiled - 1]
    print(f"[moe train] round {profiled} profile: wall_ms={wall:.3f} "
          f"device_busy_ms={busy:.3f} idle_share={1 - busy / wall:.4f} "
          "device ms by kind: " + " ".join(f"{k}={v:.3f}" for k, v in
                                            split["ms"].items())
          + " kernel launches: " + " ".join(
              f"{k}={v}" for k, v in split["launches"].items()), flush=True)
    for ms, count, key in split["top"]:
        print(f"[moe train]   {ms:9.3f} ms x{count:<6d} {key[:90]}",
              flush=True)
    check(split["launches"]["fold"] == U
          and not split["launches"]["flash_fwd"]
          and not split["launches"]["ssd_scan"],
          f"profiled launches {split['launches']}: not {U} folds alone")
    fold = moe_fold_case(torch, params, tr.layer_ids(params, cfg))
    del params
    torch.cuda.empty_cache()
    return {"launches_per_round": per_round[-1], "walls_ms": walls,
            "peak_gb": peak_gb, "idle_share": 1 - busy / wall,
            "split": split["ms"], "fold": fold}


# ---------------------------------------------------------------------------
# encoder-decoder and vision-prefix LMs, remat under torch.func, calibration
# ---------------------------------------------------------------------------

# seamless-m4t-medium prefill: 2 x (1024 frames + 4096 text tokens); its
# flash launches: 12 encoder, 12 decoder self- and 12 cross-attention
ENCDEC_TEXT = 4096
# llava-next-34b prefill: 2 x (2880 patch embeddings + 1024 text tokens)
LLAVA_TEXT = 1024
# [encdec agree]: seamless at full width, 2 + 2 blocks, f32, 2 x 64 text
# tokens over 1024 frames: the prefill's last position against stepping
# the decode path with the cross cache, within AGREE_TOL * max(1, max|logit|)
# [llava agree]: llava at full width, 2 blocks, bf16, 2 x (2880 + 64)
# positions: every position's logits through the kernel against the same
# forward with the plain attention on the card, within MOE_AGREE_BF16 *
# max(1, max|logit|) (arctic's bf16 bound; llava does not route, so every
# position, not 90% of them)
AGREE_BLOCKS = 2
AGREE_TEXT = 64
# [seamless train]: one temporal round at full width, f32 params, bf16
# compute, U clients of b rows of seq tokens, frames (U, b, 1024, 1024)
ENCDEC_TRAIN = dict(U=2, b=2, seq=256)
# [remat]: hymba-1.5b at full width, one client of 8 rows of 256 tokens in
# both layouts (on an H100 80GB HBM3 the spatial step without remat takes
# ~20 GB above its start)
REMAT_ROWS = 8
REMAT_SEQ = 256
# calibrate_constants on the card against the same call on the CPU
CALIBRATE_RTOL = 1e-4


def frontend_embeddings(torch, cfg, lead, seed: int):
    """Patch or frame embeddings (*lead, n_frontend_tokens, d_model) of
    0.02 N(0, 1), as ``launch/serve.py`` draws frames."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return 0.02 * torch.randn((*lead, cfg.n_frontend_tokens, cfg.d_model),
                              generator=gen, device="cuda")


def seamless_problems(cfg, B: int, S: int) -> dict:
    """The flash problems ``(B, H, KV, Sq, Sk, hd, causal, window)`` of one
    seamless forward over B x S text tokens and its frames, as the flash
    wrapper tallies them: encoder, decoder self- and cross-attention."""
    H, KV, hd, n = cfg.n_heads, cfg.n_kv, cfg.head_dim, cfg.n_frontend_tokens
    return {"encoder": (B, H, KV, n, n, hd, False, cfg.window),
            "decoder": (B, H, KV, S, S, hd, True, cfg.window),
            "cross": (B, H, KV, S, n, hd, False, cfg.window)}


def plain_gqa(q, k, v, *, causal=True, window=0):
    """``ops.gqa_flash`` with ``flash_attention_plain`` in the kernel's place
    (the model's (B, S, H, hd) layout)."""
    from repro_torch.kernels.flash_attention import flash_attention_plain
    return flash_attention_plain(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, window=window).transpose(1, 2)


def encdec_agree(torch) -> float:
    """seamless at full width, 2 + 2 blocks, f32 with TF32 off: the
    prefill's last-position logits (the flash kernel in the encoder, the
    decoder's self- and cross-attention) against ``decode_step`` stepped
    through the prompt with a cross cache built from an encoder run with
    ``flash_attention_plain`` in the kernel's place, so no kernel is on
    the decode side."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer as tr

    cfg = dataclasses.replace(get_config("seamless-m4t-medium"),
                              L=AGREE_BLOCKS, enc_layers=AGREE_BLOCKS,
                              dtype="float32")
    B, S = 2, AGREE_TEXT
    gen = torch.Generator(device="cuda").manual_seed(11)
    params = tr.init_params(gen, cfg, device="cuda")
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen, device="cuda")
    frames = frontend_embeddings(torch, cfg, (B,), 12)
    flash_attention.launches = 0
    pre = make_prefill_step(cfg)(params, tokens, frames)
    launched = flash_attention.launches
    t0 = time.perf_counter()
    with torch.inference_mode():
        kernel_fn, ops.gqa_flash = ops.gqa_flash, plain_gqa
        try:
            enc = tr._run_encoder(params, cfg, frames, torch.float32)
        finally:
            ops.gqa_flash = kernel_fn
        cache = tr.init_cache(cfg, B, S, device="cuda")._replace(
            cross=tr.build_cross_cache(params, cfg, enc))
        for pos in range(S):
            dec, cache = tr.decode_step(params, cfg, cache, tokens[:, pos],
                                        pos)
    torch.cuda.synchronize()
    per = cfg.enc_layers + 2 * cfg.L
    err = float((pre - dec).abs().max())
    scale = max(1.0, float(dec.abs().max()))
    print(f"[encdec agree] seamless-m4t-medium full width, {cfg.enc_layers} "
          f"+ {cfg.L} blocks, f32, B={B} text={S} frames="
          f"{cfg.n_frontend_tokens}: prefill (kernel) vs decode with the "
          f"cross cache (plain encoder): max_abs_err={err:.3e} "
          f"max_abs_logit={float(dec.abs().max()):.4f} tol={AGREE_TOL:g}"
          f"*max(1,max|logit|) decode_s={time.perf_counter() - t0:.3f} "
          f"flash launches {launched} (prefill), "
          f"{flash_attention.launches - launched} (decode side)", flush=True)
    check(bool(torch.isfinite(pre).all()), "encdec agree: logits not finite")
    check(launched == per and flash_attention.launches == launched,
          f"encdec agree: flash launches {launched} (prefill), "
          f"{flash_attention.launches - launched} (decode side)")
    check(err <= AGREE_TOL * scale,
          f"encdec agree: prefill and decode disagree: {err}")
    del params, cache, enc
    torch.cuda.empty_cache()
    return err / scale


def encdec_train(torch) -> dict:
    """One ``make_train_step(cfg, U=2, mode="temporal")`` round on
    seamless-m4t-medium at full width (f32 params, bf16 compute, remat on,
    the step's default), with frames: finite, every leaf changed (the
    encoder's and cross-attention's too: the frames reach the forward),
    one grouped fold a client and no other fold; the flash launches of one
    client's forward and of its backward's recompute, counted apart; wall
    and peak memory."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as tr
    from repro_torch.tree import tree_leaves, tree_unflatten

    cfg = get_config("seamless-m4t-medium")
    U, b, S = ENCDEC_TRAIN["U"], ENCDEC_TRAIN["b"], ENCDEC_TRAIN["seq"]
    gen = torch.Generator(device="cuda").manual_seed(13)
    params = tr.init_params(gen, cfg, device="cuda")
    tok = torch.randint(0, cfg.vocab, (U, b, S), generator=gen, device="cuda")
    lab = torch.randint(0, cfg.vocab, (U, b, S), generator=gen, device="cuda")
    frames = frontend_embeddings(torch, cfg, (U, b), 14)
    L = cfg.n_blocks_total
    mask = torch.ones((U, L), device="cuda")
    p = torch.full((L,), 0.05, device="cuda")
    counters = lm_counters()
    flash = counters["flash_attention"]

    # one client's forward and backward apart: the recompute's launches
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    flash.launches = 0
    with torch.enable_grad():
        loss = tr.loss_fn(tree_unflatten(params, leaves), cfg, tok[0], lab[0],
                          frontend=frames[0], remat=True)
        fwd = flash.launches
        torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    recompute = flash.launches - fwd
    del leaves, loss

    step = make_train_step(cfg, U=U, mode="temporal")
    sums = [float(t.sum(dtype=torch.float64)) for t in tree_leaves(params)]
    step(params, tok, lab, mask, p, 0.1, frames)         # warm-up
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    flash.shapes.clear()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    new = step(params, tok, lab, mask, p, 0.1, frames)
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {k: c.launches for k, c in counters.items()}
    flash_shapes = dict(flash.shapes)
    by_problem = {name: flash_shapes.get(prob, 0) for name, prob in
                  seamless_problems(cfg, b, S).items()}
    finite = all(bool(torch.isfinite(t).all()) for t in tree_leaves(new))
    changed = sum(float(t.sum(dtype=torch.float64)) != v
                  for t, v in zip(tree_leaves(new), sums))
    n_params = tr.count_params(params)
    print(f"[seamless train] full width {cfg.enc_layers} + {cfg.L} blocks, "
          f"{n_params} f32 params ({4 * n_params / 1e9:.2f} GB), compute "
          f"{cfg.dtype}, temporal U={U} b={b} seq={S} frames="
          f"{tuple(frames.shape)} remat=True: finite={finite} leaves_changed="
          f"{changed}/{len(sums)} wall_ms={wall:.3f} peak_mem_gb={peak_gb:.2f}"
          f" launches " + " ".join(f"{k}={v}" for k, v in launches.items())
          + f"; one client: flash forward={fwd} recompute={recompute}; "
          "flash launches by problem (wrapper): "
          + " ".join(f"{k}={v}" for k, v in by_problem.items()), flush=True)
    per_fwd = cfg.enc_layers + 2 * cfg.L
    check(finite, "seamless train: params not finite")
    check(changed == len(sums), f"{len(sums) - changed} leaves unchanged")
    check(fwd == per_fwd and recompute == per_fwd,
          f"one client's flash launches {fwd} + {recompute}, not "
          f"{per_fwd} + {per_fwd}")
    check(launches["adel_agg_grouped"] == U,
          f"{launches['adel_agg_grouped']} grouped folds, not {U}")
    check(launches["flash_attention"] == 2 * per_fwd * U,
          f"{launches['flash_attention']} flash launches, not {2 * per_fwd * U}")
    check(by_problem == {"encoder": 2 * cfg.enc_layers * U,
                         "decoder": 2 * cfg.L * U, "cross": 2 * cfg.L * U},
          f"seamless train: flash launches by problem {flash_shapes}")
    others = {k: v for k, v in launches.items()
              if k not in ("adel_agg_grouped", "flash_attention")}
    check(not any(others.values()), f"another kernel ran: {others}")
    del params, new
    torch.cuda.empty_cache()
    return {"wall_ms": wall, "peak_gb": peak_gb, "launches": launches,
            "flash_shapes": flash_shapes, "flash_forward": fwd,
            "flash_recompute": recompute}


def seamless_serve(torch) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve

    counters = lm_counters()
    for c in counters.values():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    out = serve("seamless-m4t-medium", batch=4, prompt_len=64, new_tokens=32,
                reduced=False, device="cuda", verbose=False)
    gen = torch.tensor(out["generated"])
    cfg = get_config("seamless-m4t-medium")
    print(f"[seamless serve] batch=4 prompt_len=64 new_tokens=32 frames="
          f"{cfg.n_frontend_tokens} (f32 params, f32 KV cache, bf16 cross "
          f"cache) generated={tuple(gen.shape)} prompt_s="
          f"{out['prefill_s']:.3f} decode_s={out['decode_s']:.3f} "
          f"decode_tok_per_s={out['tok_per_s']:.2f} peak_mem_gb="
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} launches "
          + " ".join(f"{k}={c.launches}" for k, c in counters.items())
          + " (the encoder through the kernel; decode is plain, as in the "
          f"reference) sample={gen[0, :8].tolist()}", flush=True)
    check(tuple(gen.shape) == (4, 32), f"generated shape {tuple(gen.shape)}")
    check(bool(((gen >= 0) & (gen < cfg.padded_vocab)).all()),
          "generated token out of range")
    check(counters["flash_attention"].launches == cfg.enc_layers,
          f"{counters['flash_attention'].launches} flash launches in serve, "
          f"not the encoder's {cfg.enc_layers}")
    torch.cuda.empty_cache()
    return out


def encdec_models(torch) -> dict:
    """seamless-m4t-medium whole in bf16 (prefill, profile), then serve,
    agree and one training round; each model's params freed before the
    next is drawn."""
    from repro_torch.configs import get_config
    cfg = get_config("seamless-m4t-medium")
    torch.cuda.reset_peak_memory_stats()
    params = init_bf16(torch, "seamless", cfg, 3)
    pre = prefill_phase(torch, "seamless", cfg, params, B=2, S=ENCDEC_TEXT)
    per = cfg.enc_layers + 2 * cfg.L
    check(pre["launches"]["flash_attention"] == per
          and pre["flash_profiled"] == per,
          f"seamless prefill: flash launches {pre['launches']} (wrapper), "
          f"{pre['flash_profiled']} (profiler), not {per}")
    by_problem = {name: pre["flash_shapes"].get(prob, 0) for name, prob in
                  seamless_problems(cfg, 2, ENCDEC_TEXT).items()}
    print("[seamless prefill] flash launches by problem (wrapper): "
          + " ".join(f"{k}={v}" for k, v in by_problem.items()), flush=True)
    check(by_problem == {"encoder": cfg.enc_layers, "decoder": cfg.L,
                         "cross": cfg.L},
          f"seamless prefill: flash launches by problem {pre['flash_shapes']}")
    others = {k: v for k, v in pre["launches"].items()
              if k != "flash_attention"}
    check(not any(others.values()), f"seamless prefill: another kernel {others}")
    del params
    torch.cuda.empty_cache()
    return {"prefill": pre, "serve": seamless_serve(torch),
            "agree": encdec_agree(torch), "train": encdec_train(torch)}


def llava_agree(torch) -> float:
    """llava at full width, 2 blocks, bf16: every position's logits of the
    forward through the flash kernel against the same forward with
    ``flash_attention_plain`` in its place (on the card), over 2 x (2880
    patches + 64 text tokens)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import transformer as tr

    cfg = dataclasses.replace(get_config("llava-next-34b"), L=AGREE_BLOCKS)
    B, S = 2, AGREE_TEXT
    gen = torch.Generator(device="cuda").manual_seed(15)
    params = tr.init_params(gen, cfg, dtype=torch.bfloat16, device="cuda")
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen, device="cuda")
    patches = frontend_embeddings(torch, cfg, (B,), 16)
    flash_attention.launches = 0
    with torch.inference_mode():
        out = tr.forward(params, cfg, tokens, frontend=patches).float()
        launched = flash_attention.launches
        kernel_fn, ops.gqa_flash = ops.gqa_flash, plain_gqa
        try:
            ref = tr.forward(params, cfg, tokens, frontend=patches).float()
        finally:
            ops.gqa_flash = kernel_fn
    torch.cuda.synchronize()
    scale = max(1.0, float(ref.abs().max()))
    errs = ((out - ref).abs().amax(-1) / scale).flatten()
    worst = float(errs.max())
    print(f"[llava agree] llava-next-34b full width, {cfg.L} blocks, bf16, "
          f"B={B} positions={cfg.n_frontend_tokens}+{S}: kernel vs plain "
          f"attention on the card: largest |difference| / max(1,max|logit|)"
          f"={worst:.3e} (max_abs_logit={float(ref.abs().max()):.4f}) "
          f"positions within tol={float((errs <= MOE_AGREE_BF16).float().mean()):.4f}"
          f" tol={MOE_AGREE_BF16:g} at every position; flash launches "
          f"{launched} (kernel run), {flash_attention.launches - launched} "
          "(plain run)", flush=True)
    check(bool(torch.isfinite(out).all()), "llava agree: logits not finite")
    check(launched == cfg.L and flash_attention.launches == launched,
          f"llava agree: flash launches {launched}, "
          f"{flash_attention.launches - launched}")
    check(worst <= MOE_AGREE_BF16,
          f"llava agree: a position {worst} from the plain run")
    del params, out, ref
    torch.cuda.empty_cache()
    return worst


def llava_models(torch) -> dict:
    """llava-next-34b whole (60 of 60 blocks, bf16, 68.8 GB): init seconds
    and peak after init, the prefill and its profile; then 2 blocks
    against the plain attention."""
    from repro_torch.configs import get_config
    cfg = get_config("llava-next-34b")
    torch.cuda.reset_peak_memory_stats()
    params = init_bf16(torch, "llava", cfg, 5)
    pre = prefill_phase(torch, "llava", cfg, params, B=2, S=LLAVA_TEXT)
    check(pre["launches"]["flash_attention"] == cfg.L
          and pre["flash_profiled"] == cfg.L,
          f"llava prefill: flash launches {pre['launches']} (wrapper), "
          f"{pre['flash_profiled']} (profiler), not {cfg.L}")
    others = {k: v for k, v in pre["launches"].items()
              if k != "flash_attention"}
    check(not any(others.values()), f"llava prefill: another kernel {others}")
    del params
    torch.cuda.empty_cache()
    return {"prefill": pre, "agree": llava_agree(torch)}


def remat_phase(torch) -> dict:
    """hymba-1.5b at full width (f32 params, bf16 compute):
    ``make_train_step`` with ``remat=False`` and ``remat=True`` on the same
    inputs, U=1, in both client layouts: spatial (one client's
    ``vmap(grad)``, as the backends run it) and temporal (autograd). Per
    layout: the updates' largest difference over the update's largest
    entry (bit for bit or not), and each run's peak memory above what was
    allocated before it, after a garbage collection (the first call) and
    its wall (the second)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as tr
    from repro_torch.tree import tree_leaves

    cfg = get_config("hymba-1.5b")
    gen = torch.Generator(device="cuda").manual_seed(17)
    params = tr.init_params(gen, cfg, device="cuda")
    out = {}
    rows = REMAT_ROWS
    for mode in ("spatial", "temporal"):
        tok = torch.randint(0, cfg.vocab, (1, rows, REMAT_SEQ), generator=gen,
                            device="cuda")
        args = (tok, tok, torch.ones((1, cfg.L), device="cuda"),
                torch.full((cfg.L,), 0.05, device="cuda"), 0.1)
        runs, kept = {}, {}
        for remat in (False, True):
            step = make_train_step(cfg, U=1, mode=mode, remat=remat)
            # a step can leave its graph in a reference cycle of
            # torch.func's, freed only when the collector runs: collect
            # before reading the start, so no earlier step's graph counts
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            new = step(params, *args)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            del new
            t0 = time.perf_counter()
            kept[remat] = step(params, *args)
            torch.cuda.synchronize()
            runs[remat] = {"wall_ms": 1e3 * (time.perf_counter() - t0),
                           "peak_gb": peak / 1e9,
                           "above_base_gb": (peak - base) / 1e9}
        a, b_ = tree_leaves(kept[False]), tree_leaves(kept[True])
        upd = max(float((x - w).abs().max())
                  for x, w in zip(a, tree_leaves(params)))
        diff = max(float((x - y).abs().max()) for x, y in zip(a, b_))
        bitwise = all(torch.equal(x, y) for x, y in zip(a, b_))
        del kept, a, b_
        saved = runs[False]["above_base_gb"] - runs[True]["above_base_gb"]
        cost = runs[True]["wall_ms"] - runs[False]["wall_ms"]
        print(f"[remat] hymba-1.5b full width, {mode} U=1 b={rows} seq="
              f"{REMAT_SEQ}: updates "
              + ("bit-identical" if bitwise else "not bit-identical")
              + f", max |difference| / max |update| = {diff / upd:.3e}; "
              + " ".join(f"remat={r}: wall_ms={v['wall_ms']:.3f} peak_mem_gb="
                         f"{v['peak_gb']:.2f} (above the step's start "
                         f"{v['above_base_gb']:.2f})" for r, v in runs.items())
              + f"; remat takes back {saved:.2f} GB for {cost:.3f} ms",
              flush=True)
        check(diff <= AGREE_UPDATE * upd,
              f"remat changes the {mode} update by {diff} (update {upd})")
        out[mode] = {"rows": rows, "bitwise": bitwise, "rel_diff": diff / upd,
                     "saved_gb": saved, "cost_ms": cost,
                     **{f"remat_{r}": v for r, v in runs.items()}}
    del params
    torch.cuda.empty_cache()
    return out


def calibrate_phase(torch, vgg: dict) -> dict:
    """``calibrate_constants`` on the MLP quickstart's data and params on
    the card against the same call on CPU copies of the params, then on
    VGG-11 (U=10, n_probe 32) on the card: seconds, sigma2, G2."""
    import numpy as np

    from repro_torch.core.types import AnalysisConfig
    from repro_torch.data.synthetic import make_image_dataset
    from repro_torch.fl.calibrate import calibrate_constants
    from repro_torch.fl.partition import dirichlet_partition, stack_clients
    from repro_torch.models.paper_models import make_mlp
    from repro_torch.tree import tree_map

    x_tr, y_tr, _, _ = make_image_dataset("mnist", n_train=2500, n_test=800,
                                          seed=0, noise_std=1.0)
    cx, cy, counts = stack_clients(x_tr, y_tr, dirichlet_partition(
        y_tr, 10, alpha=0.5, seed=0))
    model = make_mlp()
    cfg = AnalysisConfig.default(U=10, L=model.L, R=25, T_max=25 * model.L * 0.5,
                                 eta0=2.0, seed=0)
    params = model.init(torch.Generator().manual_seed(0), "cuda")
    card = calibrate_constants(cfg, model, params, cx, cy, counts)
    cpu = calibrate_constants(cfg, model, tree_map(lambda t: t.cpu(), params),
                              cx, cy, counts)
    rel = max(float(np.max(np.abs(card.sigma2 - cpu.sigma2) / cpu.sigma2)),
              abs(card.G2 - cpu.G2) / cpu.G2)
    print(f"[calibrate] mlp U=10 n_probe=32: card vs cpu max relative "
          f"difference {rel:.3e} (rtol {CALIBRATE_RTOL:g}) sigma2="
          f"{[round(float(v), 6) for v in card.sigma2]} G2={card.G2:.6f}",
          flush=True)
    check(rel <= CALIBRATE_RTOL, f"calibrate: card and cpu differ by {rel}")
    cx, cy, counts = vgg["data"][:3]
    model, cfg = vgg["model"], vgg["cfg"]
    params = model.init(torch.Generator().manual_seed(0), "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = calibrate_constants(cfg, model, params, cx, cy, counts, n_probe=32)
    secs = time.perf_counter() - t0
    print(f"[calibrate] vgg11 U={cfg.U} n_probe=32 on the card: "
          f"seconds={secs:.3f} sigma2={[round(float(v), 6) for v in out.sigma2]}"
          f" G2={out.G2:.6f}", flush=True)
    check(bool(np.all(np.isfinite(out.sigma2)) and np.all(out.sigma2 > 0)
               and math.isfinite(out.G2) and out.G2 > 0),
          "calibrate: VGG-11 constants not finite and positive")
    del params
    torch.cuda.empty_cache()
    return {"mlp_rel_diff": rel, "vgg_seconds": secs, "vgg_G2": out.G2}


# ---------------------------------------------------------------------------
# the launch and tooling layer: the dry run on a fake production mesh, its
# count against the card, and the examples
# ---------------------------------------------------------------------------

# [dryrun]: every arch x prefill_32k and decode_32k at full production width
# on the fake 16 x 16 mesh, and train_4k (temporal) of these archs through
# the cost probe's four reduced-depth probes; tasks spread over worker
# processes on the host's cores (meta tensors: no card, no memory)
DRYRUN_SHAPES = ("prefill_32k", "decode_32k")
DRYRUN_TRAIN_ARCHS = ("yi-6b", "hymba-1.5b")
DRYRUN_WORKERS = 8
DRYRUN_TIMEOUT_S = 400
# [examples]: the port's serve example at full width (the reference
# example's default arch); mamba2-370m's 48 SSD blocks through ssd_scan
EXAMPLE_SERVE_ARCH = "mamba2-370m"


def dryrun_task(task: tuple) -> dict:
    """One dry-run count in a worker process (spawned: imports nothing of
    the parent's state), on a fake world of its own: ``("combo", arch,
    shape)`` on the production mesh; ``("probe", arch, shape, U, l)``, a
    reduced-depth temporal train step of U clients at the production
    per-client batch; ``("card", tag, arch, B, S, front_dtype)``, a prefill
    on a 1 x 1 mesh at the shape and dtypes a card phase runs (S its
    ``InputShape.seq_len``)."""
    import dataclasses

    sys.path.insert(0, str(SRC))
    import torch
    torch.set_num_threads(1)
    from repro_torch.configs import get_config, get_shape
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import costprobe, dryrun
    from repro_torch.launch.mesh import (batch_shards, make_production_mesh)

    t0 = time.perf_counter()
    kind = task[0]
    if kind == "card":
        _, tag, arch, B, S, front = task
        rec = dryrun.run_combo(
            arch, f"card_{tag}", mesh=dryrun.make_mesh((1, 1), ("data",
                                                                "model")),
            shape=InputShape(f"card_{tag}", S, B, "prefill"), verbose=False,
            detail=True, frontend_dtype=getattr(torch, front))
    else:
        dryrun.open_world(256)
        mesh = make_production_mesh()
        if kind == "combo":
            rec = dryrun.run_combo(task[1], task[2], mesh=mesh, verbose=False,
                                   detail=True)
        else:
            _, arch, shape_name, u, l = task
            shape = get_shape(shape_name)
            U_star = max(shape.global_batch // batch_shards(mesh), 1)
            cfg = costprobe._reduced_cfg(get_config(arch), l)
            rec = dryrun.run_combo(
                arch, shape_name, mesh=mesh, cfg=cfg, verbose=False,
                detail=True, shape=dataclasses.replace(
                    shape, global_batch=u * (shape.global_batch // U_star)))
            rec["U_star"] = U_star
    rec["task"] = list(task)
    rec["seconds"] = time.perf_counter() - t0
    return rec


def dryrun_line(tag: str, rec: dict) -> str:
    coll = rec["collective_bytes_per_device"]
    return (f"[{tag}] {rec['arch']} x {rec['shape']} x {rec['mesh']} "
            f"({rec['step']}): flops/dev={rec['flops_per_device']:.6e} "
            f"(products {rec['detail']['flops_by_kind']['products']:.6e}) "
            f"bytes/dev={rec['bytes_per_device']:.6e} coll/dev="
            + " ".join(f"{k}:{v:.6e}" for k, v in coll.items()
                       if k not in ("total", "count"))
            + f" total:{coll['total']:.6e} count:{coll['count']} dominant="
            f"{rec['roofline']['dominant']} traced_s={rec['seconds']:.1f} "
            f"regathered={rec['detail']['regathered_ops']}")


def run_dryrun_tasks(tasks: list) -> list:
    """The tasks over ``DRYRUN_WORKERS`` spawned processes, longest first
    as listed; every worker is stopped before this returns."""
    import concurrent.futures
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=min(DRYRUN_WORKERS, len(tasks)), mp_context=ctx)
    try:
        import traceback
        futures = [pool.submit(dryrun_task, t) for t in tasks]
        out, failed = [], []
        for t, f in zip(tasks, futures):
            try:
                out.append(f.result(timeout=DRYRUN_TIMEOUT_S))
            except Exception as exc:    # each worker's traceback, then fail
                print(f"chip_smoke: dryrun task {t} failed:\n"
                      + "".join(traceback.format_exception(exc)),
                      file=sys.stderr, flush=True)
                failed.append(f"{t}: {type(exc).__name__}: {exc}")
        check(not failed, f"dryrun: {len(failed)} tasks failed: {failed}")
        return out
    finally:
        for proc in list(getattr(pool, "_processes", {}).values()):
            if proc.is_alive():
                proc.terminate()
        pool.shutdown(wait=True, cancel_futures=True)


def dryrun_phases(torch, cards: dict) -> None:
    """``[dryrun]``: every arch x ``DRYRUN_SHAPES`` on the fake 16 x 16
    production mesh at full width, and ``train_4k`` (temporal) of
    ``DRYRUN_TRAIN_ARCHS`` extrapolated from the cost probe's four
    reduced-depth probes (``launch/costprobe.py``); a combo that raises
    fails the phase. ``[dryrun vs card]``: the prefills this script timed
    on the card (``cards``: tag -> arch, B, S, frontend dtype, median wall,
    device-busy ms, peak and the bytes of the params and inputs on the
    card), each counted on a 1 x 1 fake mesh: FLOPs, their share of the
    bf16 peak over the busy time, and the argument bytes against the
    card's, which must be equal."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch import costprobe, dryrun

    tasks = [("card", tag, c["arch"], c["B"], c["seq_len"], c["front"])
             for tag, c in cards.items()]
    tasks += [("combo", arch, shape) for arch in ARCHS
              for shape in DRYRUN_SHAPES]
    tasks += [("probe", arch, "train_4k", u, l) for arch in DRYRUN_TRAIN_ARCHS
              for u, l in costprobe.TRAIN_PROBES]
    # the SSD archs' prefills (a chunk loop a block) take longest: first
    slow = [("combo", arch, "prefill_32k")
            for arch in ("mamba2-370m", "hymba-1.5b")]
    tasks = slow + [t for t in tasks if t not in slow]
    t0 = time.perf_counter()
    recs = run_dryrun_tasks(tasks)      # a combo that raises fails the phase
    wall = time.perf_counter() - t0
    by_task = {tuple(r["task"]): r for r in recs}
    for t in tasks:
        if t[0] == "combo":
            print(dryrun_line("dryrun", by_task[t]), flush=True)
    for arch in DRYRUN_TRAIN_ARCHS:
        samples = {f"U{t[3]}_L{t[4]}": {
            "flops": float(r["flops_per_device"]),
            "bytes": float(r["bytes_per_device"]),
            "coll": float(r["collective_bytes_per_device"]["total"])}
            for t, r in by_task.items() if t[0] == "probe" and t[1] == arch}
        U_star = next(r["U_star"] for r in recs if r["task"][0] == "probe"
                      and r["task"][1] == arch)
        cfg = ARCHS[arch]
        est = costprobe._train_extrapolation(samples, U_star, cfg.L)
        secs = sum(r["seconds"] for r in recs if r["task"][0] == "probe"
                   and r["task"][1] == arch)
        roof = dryrun.roofline(est["flops"], est["bytes"], est["coll"])
        print(f"[dryrun] {arch} x train_4k x 16x16 (train_step, temporal, "
              f"U={U_star} L={cfg.L}, from probes (U, l) in "
              f"{list(costprobe.TRAIN_PROBES)}): flops/dev={est['flops']:.6e}"
              f" bytes/dev={est['bytes']:.6e} coll/dev={est['coll']:.6e} "
              f"dominant={roof['dominant']} traced_s={secs:.1f} (4 probes)",
              flush=True)
    card = card_line()
    for tag, c in cards.items():
        rec = by_task[("card", tag, c["arch"], c["B"], c["seq_len"],
                       c["front"])]
        flops = rec["flops_per_device"]
        prod = rec["detail"]["flops_by_kind"]["products"]
        args = rec["memory"]["argument_size_in_bytes"]
        share = flops / (c["busy_ms"] / 1e3) / dryrun.PEAK_FLOPS
        print(f"[dryrun vs card] {tag} {c['arch']} prefill B={c['B']} "
              f"seq_len={c['seq_len']} text={rec['seq']} (1 x 1 mesh): "
              f"flops={flops:.6e} (products "
              f"{prod:.6e}) argument_bytes={args} card_argument_bytes="
              f"{c['arg_bytes']} median_wall_ms={c['wall_ms']:.3f} "
              f"device_busy_ms={c['busy_ms']:.3f} peak_mem_gb="
              f"{c['peak_gb']:.2f} flops/busy/989 TFLOP/s={share:.4f} "
              f"flops/wall/989 TFLOP/s="
              f"{flops / (c['wall_ms'] / 1e3) / dryrun.PEAK_FLOPS:.4f} "
              f"traced_s={rec['seconds']:.1f} card: {card}",
              flush=True)
        check(args == c["arg_bytes"],
              f"dryrun vs card {tag}: argument bytes {args} != the card's "
              f"{c['arg_bytes']}")
        check(prod > 0, f"dryrun vs card {tag}: no products counted")
    print(f"[dryrun] {len(tasks)} tasks on {DRYRUN_WORKERS} worker processes"
          f" in {wall:.1f} s (constants: PEAK_FLOPS={dryrun.PEAK_FLOPS:g} "
          f"HBM_BW={dryrun.HBM_BW:g} ICI_BW={dryrun.ICI_BW:g})", flush=True)


def load_example(name: str):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def examples_phase(torch) -> None:
    """``examples/torch_quickstart.py`` on the card through its ``main``
    (ADEL above chance, within its budget), then
    ``examples/torch_serve_llm.py --arch mamba2-370m --full`` (the
    reference example's default arch, whole, at full width): its batched
    prefill through ``ssd_scan`` (one launch a block), the decode's
    tokens/s, and its next tokens against the same prefill through the
    plain scan (:func:`serve_first_tokens`)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan import ssd_scan

    t0 = time.perf_counter()
    hist = load_example("torch_quickstart").main([])
    quick_s = time.perf_counter() - t0
    acc = {k: h.accuracy[-1] for k, h in hist.items()}
    print(f"[examples] torch_quickstart.py on the card: final accuracy "
          f"{acc} wall_s={quick_s:.3f}", flush=True)
    check(acc["adel"] > 0.1, f"quickstart example: ADEL at {acc['adel']}")
    check(all(h.times[-1] <= 60.0 * 1.001 for h in hist.values()),
          "quickstart example: simulated clock over its budget")
    cfg = get_config(EXAMPLE_SERVE_ARCH)
    counters = lm_counters()
    for c in counters.values():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    serve_ex = load_example("torch_serve_llm")
    out = serve_ex.main(["--arch", EXAMPLE_SERVE_ARCH, "--full"])
    serve_s = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    print(f"[examples] torch_serve_llm.py --arch {EXAMPLE_SERVE_ARCH} --full "
          f"({cfg.L} blocks, d_model {cfg.d_model}): prefill "
          f"{out['prefill_tok_per_s']:.1f} tok/s, decode "
          f"{out['tok_per_s']:.2f} tok/s, first token agrees in "
          f"{out['first_token_agree']} of 4 rows, launches "
          + " ".join(f"{k}={v}" for k, v in launches.items())
          + f" peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f} "
          f"wall_s={serve_s:.3f}", flush=True)
    # two prefills (warm-up and timed) through the kernel, one a block
    check(launches["ssd_scan"] == 2 * cfg.L,
          f"serve example: {launches['ssd_scan']} ssd_scan launches, not "
          f"{2 * cfg.L}")
    check(np_shape(out["generated"]) == (4, 48),
          f"serve example: generated {np_shape(out['generated'])}")
    serve_first_tokens(torch, serve_ex, out)
    torch.cuda.empty_cache()


def serve_first_tokens(torch, serve_ex, out) -> None:
    """The serve example's prefill (4 x 32 tokens, seed 0) again, through
    the kernel and through ``ssd_scan_plain`` on the card (the model's
    ``ops.SSDScan`` swapped for the plain scan). In the example's bf16
    compute, row by row beside the decode's first token: each one's next
    token, the gap between the two largest kernel logits and the largest
    |kernel - plain| logit (a token can differ only where that gap is
    under twice the difference). The same prefill in f32 compute must
    agree within ``AGREE_TOL`` of the logits' scale, as ``[hymba
    agree]``'s."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd_scan import ssd_scan_plain
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer as tr

    class PlainScan:
        @staticmethod
        def apply(xdt, la, b, c, chunk):
            return ssd_scan_plain(xdt, la, b, c, chunk=chunk)

    def kernel_and_plain(run):
        kern = run().float()
        saved, ops.SSDScan = ops.SSDScan, PlainScan
        try:
            plain = run().float()
        finally:
            ops.SSDScan = saved
        return kern, plain

    dev = torch.device("cuda")
    kern, plain = kernel_and_plain(lambda: serve_ex.prefill(
        EXAMPLE_SERVE_ARCH, batch=4, prompt_len=32, full=True, seed=0,
        device=dev)["logits"])
    for row, gen in enumerate(out["generated"]):
        top = kern[row].topk(2)
        print(f"[examples] serve row {row} (bf16): next token decode "
              f"{gen[0]} kernel prefill {int(kern[row].argmax())} plain prefill "
              f"{int(plain[row].argmax())}; kernel top-two gap "
              f"{float(top.values[0] - top.values[1]):.6e} max |kernel - "
              f"plain| {float((kern[row] - plain[row]).abs().max()):.6e}",
              flush=True)
    cfg = dataclasses.replace(get_config(EXAMPLE_SERVE_ARCH), dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = tr.init_params(gen, cfg, device=dev)
    prompts = torch.randint(0, cfg.vocab, (4, 32), generator=gen, device=dev)
    step = make_prefill_step(cfg)
    kern, plain = kernel_and_plain(lambda: step(params, prompts))
    diff = float((kern - plain).abs().max())
    scale = max(1.0, float(plain.abs().max()))
    same = int((kern.argmax(-1) == plain.argmax(-1)).sum())
    print(f"[examples] serve prefill in f32: max |kernel - plain| {diff:.6e} "
          f"of max |logit| {scale:.6e}, next tokens equal in {same} of 4 "
          "rows", flush=True)
    check(diff <= AGREE_TOL * scale,
          f"serve prefill in f32: kernel and plain logits {diff} apart, over "
          f"{AGREE_TOL} x {scale}")
    del params


def np_shape(rows) -> tuple:
    return (len(rows), len(rows[0]) if rows else 0)


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
    libs = build.build_all()
    print(f"[build] {', '.join(f'{n}.cu -> {p.relative_to(ROOT)}' for n, p in libs.items())}"
          f" in {time.perf_counter() - t0:.3f} s, in parallel "
          f"(nvcc {' '.join(build.NVCC_FLAGS)})", flush=True)
    build_report()

    leaf_F = vgg_leaf_features()
    rows = kernel_cases(torch, leaf_F)
    per_round = fold_round(torch, leaf_F)
    lm_rows = lm_kernel_cases(torch)
    vgg = vgg_setup(torch)
    launches = vgg_runs(torch, vgg)
    fold_slices(torch, leaf_F)
    backend_launches = vgg_backends(torch, vgg)
    vgg_heterofl(torch, vgg)
    vgg_phases(torch, vgg)
    with tempfile.TemporaryDirectory() as tmp:
        import torch.distributed as dist
        store = dist.FileStore(str(Path(tmp) / "nccl_store"), 1)
        dist.init_process_group("nccl", store=store, rank=0, world_size=1)
        try:
            shard = vgg_shard_map_nccl(torch, vgg)
            vgg_pipeline(torch, vgg)
        finally:
            dist.destroy_process_group()
        vgg_shard_map_gloo(torch, vgg, tmp)
    for path, n in shard.items():
        backend_launches[path]["shard_map"] = n
    buffered = vgg_buffered(torch, vgg)
    fleet = vgg_fleet(torch, vgg)
    fleet_scenarios(torch)
    mlp_quickstart(torch)
    prefill = hymba_prefill(torch)
    launches.update(prefill["launches"])
    hymba_serve(torch)
    hymba_agree(torch)
    grad_rows = lm_grad_cases(torch)
    training = lm_training(torch, grad_rows)
    lm_backends = lm_dense_vs_temporal(torch)
    moe = moe_models(torch)
    moe_train = moe_training(torch)
    encdec = encdec_models(torch)
    llava = llava_models(torch)
    remat_phase(torch)
    calibrate_phase(torch, vgg)
    examples_phase(torch)
    cards = {tag: {**pre["card"], "wall_ms": pre["wall_ms"],
                   "busy_ms": pre["busy_ms"], "peak_gb": pre["peak_gb"]}
             for tag, pre in (("hymba", prefill),
                              ("deepseek", moe["deepseek_prefill"]),
                              ("seamless", encdec["prefill"]),
                              ("llava", llava["prefill"]))}
    dryrun_phases(torch, cards)

    replaces = {"adel_agg": "src/repro/kernels/adel_agg.py:34",
                "adel_agg_q8": "src/repro/kernels/adel_agg.py:76"}
    entries = {"adel_agg": "adel_agg_grouped (fold_grouped_kernel)",
               "adel_agg_q8": "adel_agg_q8_grouped (fold_grouped_q8_kernel)"}
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
            "library_ms": rnd["library_ms"], "call_ms": rnd["call_ms"],
            "entry": entries[name],
            "launches_per_round_by_backend": backend_launches[name],
            "buffered_launches_by_round": buffered[name],
            "shapes": "one round's fold: 38 VGG-11 leaves at U=10, "
                      + ("f32" if name == "adel_agg" else "int8")
                      + ", one grouped launch",
            "card": card})
    kernels[1]["per_leaf_ms"] = per_round["adel_agg_q8 per-leaf"]["ms"]
    kernels[0]["fleet_hierarchical_launches_by_round"] = fleet
    kernels[0]["lm_training_launches_per_round"] = \
        training["launches_per_round"]["adel_agg_grouped"]
    kernels[0]["lm_launches_a_round_4_blocks"] = {
        bk: lm_backends[("none", bk)] for bk in ("dense", "temporal")}
    kernels[1]["lm_launches_a_round_4_blocks"] = {
        bk: lm_backends[("int8", bk)] for bk in ("dense", "temporal")}
    kernels[0]["moe_training_launches_per_round"] = \
        moe_train["launches_per_round"]["adel_agg_grouped"]
    kernels[0]["moe_training_client_fold"] = moe_train["fold"]
    lm_replaces = {"flash_attention": "src/repro/kernels/flash_attention.py:76",
                   "ssd_scan": "src/repro/kernels/ssd_scan.py:72"}
    for name, main_case in (("flash_attention", ("hymba", "bf16")),
                            ("ssd_scan", ("model", "ssd"))):
        mine = [r for r in lm_rows if r["kernel"] == name]
        row = next(r for r in mine if (r["case"], r["dtype"]) == main_case)
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": lm_replaces[name], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "shapes": f"one block of the hymba-1.5b prefill: {row['shape']}"
                      + (" bf16" if name == "flash_attention" else " f32"),
            "lm_training_launches_per_round":
                training["launches_per_round"][name],
            "lm_training_plain_backward_ms_per_round":
                training["plain_backward_ms"][name],
            "grad_max_err": {f"{r['dtype']} {r['case']}": r["max_err"]
                             for r in grad_rows if r["kernel"] == name},
            "training_block": {
                f"{r['dtype']} {r['case']}": {
                    "kernel_device_ms": r["kernel_device_ms"],
                    "bound_ms": r["bound_ms"]}
                for r in grad_rows if r["kernel"] == name},
            "card": card})
        if name == "flash_attention":
            yi = next(r for r in mine if (r["case"], r["dtype"]) == ("yi", "bf16"))
            kernels[-1].update(yi6b_ms=yi["kernel_ms"],
                               yi6b_library_ms=yi["library_ms"])
            # the f32 kernel (3xTF32) where the main path runs it most
            kernels[-1]["f32"] = {
                r["case"]: {k: r[k] for k in (
                    "kernel_ms", "library_ms", "bound_ms",
                    "cuda_core_bound_ms", "max_abs_err")}
                for r in mine if r["dtype"] == "f32"
                and r["case"] in ("seamless_decoder", "train_block")}
            arc = next(r for r in mine
                       if (r["case"], r["dtype"]) == ("arctic", "bf16"))
            kernels[-1]["arctic_gqa7"] = {
                k: arc[k] for k in ("shape", "max_abs_err", "plain_ms",
                                    "library_ms", "bound_ms", "bound_by")}
            kernels[-1]["arctic_gqa7"].update(
                ms=arc["kernel_ms"], launches_per_prefill=moe[
                    "arctic_prefill"]["launches"]["flash_attention"])
            # each problem's launches in the runs that make it, by the
            # wrapper's tally (null where no run here makes it)
            runs = {"launches_per_prefill": (encdec["prefill"],
                                             llava["prefill"]),
                    "launches_per_train_round": (encdec["train"],)}
            for case in ("seamless_encoder", "seamless_decoder",
                         "seamless_cross", "seamless_train_self",
                         "seamless_train_cross", "llava", "train_block"):
                new = {r["dtype"]: r for r in mine if r["case"] == case}
                prob = new["bf16"]["problem"]
                kernels[-1][case] = {
                    "shape": new["bf16"]["shape"],
                    **{key: sum(r["flash_shapes"].get(prob, 0) for r in rs)
                       or None for key, rs in runs.items()},
                    **{dt: {k: r[k] for k in (
                        "kernel_ms", "plain_ms", "library_ms", "bound_ms",
                        "bound_by", "max_abs_err")}
                       for dt, r in new.items()}}
        else:
            # the one kernel's device ms (torch.profiler), the CUDA cores'
            # bound beside the 3xTF32 one, the other shapes' numbers
            kernels[-1].update(device_ms=row["device_ms"],
                               cuda_core_bound_ms=row["cuda_core_bound_ms"],
                               bit_equal=all(r["bit_equal"] for r in mine))
            for case in ("hymba", "mamba2", "train_block"):
                r = next(r for r in mine if r["case"] == case)
                kernels[-1][case] = {k: r[k] for k in (
                    "shape", "kernel_ms", "device_ms", "plain_ms", "bound_ms",
                    "bound_by", "cuda_core_bound_ms", "max_abs_err")}
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
