#!/usr/bin/env python3
"""Quick check of the flash attention kernels on the card (~1-2 min).

    python scripts/flash_check.py [--src DIR] [--label NAME] [--time-only]

Builds ``csrc/flash_attention.cu`` and prints ptxas's report and the
library's count of ``HGMMA`` (bf16 and tf32 apart) and ``UTMALDG`` SASS
instructions; runs each case below in bf16 and f32 against
``flash_attention_plain`` (rtol 1e-2 / atol 1e-3 in bf16, 2e-5 in f32),
the f32 kernel's tile edges (Sq and Sk of 1, 63, 65, 1000), two f32
diagnostics (q = 0, so P is uniform and only the P V path shows; and V one
column per key, so the output is P itself), two calls bit for bit, then
``gqa_flash`` on (B, S, H, hd) tensors; and times the shapes of
``chip_smoke.py``'s flash cases (f32 and bf16) against
``scaled_dot_product_attention`` as CUDA-graph replays (device time; the
kernel also as 20 eager calls after 3 of warm-up), with both f32 bounds (CUDA cores, 67 TFLOP/s; 3xTF32 on the
tensor cores, 495 / 3 TFLOP/s), and names the kernels SDPA's f32 call
launches. Failing cases are printed, not raised: this is the first, short
call after a change to the kernel, before ``chip_smoke.py``. Ends with one
JSON line of the times.

``--src DIR`` imports ``repro_torch`` from another tree's ``src`` (a parent
unpacked with ``git archive`` under ``build/``), which builds into that
tree's own ``build/``; run it beside this tree's in one call for an A/B,
``--time-only`` for the times alone. Needs a CUDA device.
"""
import argparse
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

import torch
import torch.nn.functional as F

CASES = [  # B, H, KV, Sq, Sk, hd, causal, window
    (1, 1, 1, 128, 128, 64, False, 0),
    (1, 1, 1, 128, 128, 128, False, 0),
    (1, 2, 1, 256, 256, 64, True, 0),
    (2, 25, 5, 1024, 1024, 64, True, 256),
    (1, 32, 4, 512, 512, 128, True, 0),
    (1, 4, 2, 1000, 1000, 64, True, 100),
    (2, 2, 2, 128, 300, 64, False, 0),
    (1, 8, 1, 77, 77, 128, True, 0),
    (1, 2, 1, 200, 40, 64, True, 16),
    (1, 4, 2, 1000, 1000, 128, True, 0),
    (1, 14, 2, 700, 900, 128, False, 200),
]
EDGES = (1, 63, 65, 1000)

TIMED = [  # tag, B, H, KV, Sq, Sk, hd, causal, window, dtypes (chip_smoke.py's)
    ("hymba", 2, 25, 5, 4096, 4096, 64, True, 1024, ("bf16", "f32")),
    ("yi", 2, 32, 4, 2048, 2048, 128, True, 0, ("bf16",)),
    ("seamless_encoder", 2, 16, 16, 1024, 1024, 64, False, 0, ("bf16", "f32")),
    ("seamless_decoder", 2, 16, 16, 4096, 4096, 64, True, 0, ("bf16", "f32")),
    ("seamless_cross", 2, 16, 16, 4096, 1024, 64, False, 0, ("bf16", "f32")),
    ("seamless_train_self", 2, 16, 16, 256, 256, 64, True, 0, ("bf16", "f32")),
    ("seamless_train_cross", 2, 16, 16, 256, 1024, 64, False, 0,
     ("bf16", "f32")),
    ("llava", 2, 56, 8, 3904, 3904, 128, True, 0, ("bf16", "f32")),
    ("train_block", 8, 25, 5, 256, 256, 64, True, 1024, ("bf16", "f32")),
]
HBM, F32_PEAK, TF32_PEAK, BF16_PEAK = 3.35e12, 67e12, 495e12, 989e12


def events_ms(fn, n=20):
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def graph_ms(fn, reps=10, replays=5):
    """Device time a call: ``reps`` calls captured in one CUDA graph and
    replayed, so the host's launch cost is not in the number."""
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
    return start.elapsed_time(end) / (reps * replays)


def bound(nbytes, flops, peak):
    return 1e3 * max(nbytes / HBM, flops / peak)


def checks(gen):
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.ops import gqa_flash

    def one(dtype, B, H, KV, Sq, Sk, hd, causal, window, tag="", qkv=None):
        rtol, atol = (1e-2, 1e-3) if dtype == torch.bfloat16 else (2e-5, 2e-5)
        try:
            q, k, v = qkv or [torch.randn(s, generator=gen, device="cuda").to(dtype)
                              for s in ((B, H, Sq, hd), (B, KV, Sk, hd),
                                        (B, KV, Sk, hd))]
            out = flash_attention(q, k, v, causal=causal, window=window)
            again = flash_attention(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            ref = flash_attention_plain(q, k, v, causal=causal, window=window)
            err = (out.float() - ref.float()).abs()
            bad = err > atol + rtol * ref.float().abs()
            print(tag, dtype, (B, H, KV, Sq, Sk, hd, causal, window), "maxerr",
                  float(err.max()), "nbad", int(bad.sum()), "of", bad.numel(),
                  "finite", bool(torch.isfinite(out.float()).all()),
                  "bitequal", torch.equal(out, again), flush=True)
            return out, ref
        except Exception:
            traceback.print_exc()
            return None, None

    for dtype in (torch.bfloat16, torch.float32):
        for case in CASES:
            one(dtype, *case)
    for hd in (64, 128):
        for Sq in EDGES:
            for Sk in EDGES:
                for causal, window in ((True, 0), (False, 0), (True, 64)):
                    one(torch.float32, 1, 2, 1, Sq, Sk, hd, causal, window,
                        tag="edge")
    # diagnostics of the f32 kernel's two products
    for hd in (64, 128):
        B, H, KV, S = 1, 2, 1, 64
        v = torch.randn((B, KV, S, hd), generator=gen, device="cuda")
        zq = torch.zeros((B, H, S, hd), device="cuda")
        k = torch.randn((B, KV, S, hd), generator=gen, device="cuda")
        one(torch.float32, B, H, KV, S, S, hd, False, 0, tag="diag uniform-P",
            qkv=(zq, k, v))
        q = torch.randn((B, H, S, hd), generator=gen, device="cuda")
        eye = torch.zeros((B, KV, S, hd), device="cuda")
        eye[0, 0, torch.arange(S), torch.arange(S) % hd] = 1.0
        out, ref = one(torch.float32, B, H, KV, S, S, hd, False, 0,
                       tag="diag one-hot-V", qkv=(q, k, eye))
        if out is not None:
            perm = [int(i) for i in (out[0, 0, 0, :8] - ref[0, 0, 0, :8])
                    .abs().gt(1e-5).nonzero().flatten()]
            print("diag one-hot-V: row 0, keys 0-7 off:", perm,
                  "kernel", out[0, 0, 0, :8].tolist(), "plain",
                  ref[0, 0, 0, :8].tolist(), flush=True)
    for dtype in (torch.bfloat16, torch.float32):
        B, S, H, KV, hd = 2, 1024, 25, 5, 64
        q = torch.randn((B, S, H, hd), generator=gen, device="cuda").to(dtype)
        k = torch.randn((B, S, KV, hd), generator=gen, device="cuda").to(dtype)
        v = torch.randn((B, S, KV, hd), generator=gen, device="cuda").to(dtype)
        out = gqa_flash(q, k, v, causal=True, window=256)
        ref = flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                                    v.transpose(1, 2), causal=True,
                                    window=256).transpose(1, 2)
        print("model layout", dtype, "maxerr",
              float((out.float() - ref.float()).abs().max()), "contiguous out",
              out.is_contiguous(), flush=True)


def times(gen, label):
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     visible_mask,
                                                     visible_pairs)
    rows = []
    for tag, B, H, KV, Sq, Sk, hd, causal, window, dtypes in TIMED:
        for dt in dtypes:
            dtype = torch.bfloat16 if dt == "bf16" else torch.float32
            q = torch.randn((B, H, Sq, hd), generator=gen, device="cuda").to(dtype)
            k = torch.randn((B, KV, Sk, hd), generator=gen, device="cuda").to(dtype)
            v = torch.randn((B, KV, Sk, hd), generator=gen, device="cuda").to(dtype)
            mask = visible_mask(Sq, Sk, causal, window, "cuda") if window else None
            def run():
                return flash_attention(q, k, v, causal=causal, window=window)

            def sdpa_run():
                return F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, is_causal=causal and mask is None,
                    enable_gqa=True)

            kernel, sdpa = graph_ms(run), graph_ms(sdpa_run)
            kernel_eager = events_ms(run)
            nbytes = (2 * B * H * Sq * hd + 2 * B * KV * Sk * hd) * q.element_size()
            flops = 4 * B * H * hd * visible_pairs(Sq, Sk, causal=causal,
                                                   window=window)
            row = {"label": label, "case": tag, "dtype": dt, "kernel_ms": kernel,
                   "sdpa_ms": sdpa, "kernel_eager_ms": kernel_eager}
            if dt == "f32":
                row.update(cuda_core_bound_ms=bound(nbytes, flops, F32_PEAK),
                           tf32x3_bound_ms=bound(nbytes, flops, TF32_PEAK / 3))
            else:
                row.update(bound_ms=bound(nbytes, flops, BF16_PEAK))
            print("time", json.dumps(row), flush=True)
            rows.append(row)
            del q, k, v
    return rows


def sdpa_kernels(gen):
    """The device kernels one f32 SDPA call at seamless's decoder shape runs."""
    from torch.profiler import ProfilerActivity, profile
    q = torch.randn((2, 16, 4096, 64), generator=gen, device="cuda")
    F.scaled_dot_product_attention(q, q, q, is_causal=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(200):
            torch.cuda._sleep(1_000)
        torch.cuda._sleep(20_000_000)
        F.scaled_dot_product_attention(q, q, q, is_causal=True)
        torch.cuda.synchronize()
        time.sleep(0.5)
    names = sorted({e.key for e in prof.key_averages()
                    if "sleep" not in e.key and "spin" not in e.key})
    print("sdpa f32 kernels:", names, flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--time-only", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_check: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build
    print(args.label, subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    t0 = time.time()
    lib = build.build("flash_attention")
    print(f"built in {time.time() - t0:.1f} s", flush=True)
    print("\n".join(line for line in build.ptxas_report("flash_attention")
                    .read_text().splitlines()
                    if "registers" in line or "spill" in line or "entry" in line
                    or "arning" in line or "rror" in line), flush=True)
    sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", str(lib)],
                          capture_output=True, text=True).stdout
    hgmma = [line for line in sass.splitlines() if "HGMMA" in line]
    print("HGMMA", len(hgmma), "of them TF32",
          sum(".TF32" in line for line in hgmma), "BF16",
          sum(".BF16" in line for line in hgmma), "UTMALDG",
          sass.count("UTMALDG"), flush=True)
    print("HGMMA forms:", sorted({line.split("HGMMA")[1].split()[0]
                                  for line in hgmma}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    if not args.time_only:
        checks(gen)
        sdpa_kernels(gen)
    rows = times(gen, args.label)
    print(json.dumps({"flash_check": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
