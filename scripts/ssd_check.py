#!/usr/bin/env python3
"""Quick check of the SSD chunk scan kernel on the card (~1-2 min).

    python scripts/ssd_check.py [--src DIR] [--label NAME] [--time-only]

Builds ``csrc/ssd_scan.cu`` and prints ptxas's report (registers, spills,
warnings) and the library's count of tf32 ``HGMMA`` SASS instructions;
runs each case below against ``ssd_scan_plain`` (``chip_smoke.py``'s SSD
tolerance, rtol = atol = 1e-4) with two calls bit for bit, on contiguous
inputs and on (B, H, S, P) views of the model's (B, S, H, P) tensors
(bit-equal to the contiguous call), printing the plan each call takes (the
cases are chosen so that the plans reach every P width and state width
each kernel takes); then times the main path's shapes (hymba-1.5b's
prefill block, contiguous and in the model's layout, mamba2-370m's,
hymba's training block and the same under vmap over 4 clients) as
CUDA-graph replays beside the bound. The cost, the bounds and
the timer are ``chip_smoke.py``'s. Failing cases are printed, not raised:
this is the first, short call after a change to the kernel, before
``chip_smoke.py``. Ends with one JSON line of the times.

``--src DIR`` imports ``repro_torch`` from another tree's ``src`` (a parent
unpacked with ``git archive`` under ``build/``), which builds into that
tree's own ``build/``; with ``--time-only`` it times that tree's kernel,
for an A/B in one call. Needs a CUDA device.
"""
import argparse
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402  (the cost, bounds, timer and tolerance)

CASES = [  # G, r, S, P, N, Q; the kernel the plan picks
    (1, 1, 64, 16, 8, 64),         # one tile; ws<16, 16>
    (1, 1, 128, 16, 8, 64),        # the state handed to a second tile
    (2, 64, 1024, 50, 16, 64),     # hymba-1.5b's prefill widths; ws<64, 16>
    (3, 64, 256, 50, 16, 64),      # a grid over the SMs; tc<56, 16>
    (1, 140, 128, 16, 8, 64),      # tc<16, 16>
    (2, 70, 128, 30, 20, 64),      # tc<32, 32>
    (1, 140, 128, 64, 24, 64),     # tc<64, 32>
    (1, 4, 192, 24, 30, 64),       # ws<32, 32>
    (1, 32, 512, 64, 128, 64),     # mamba2-370m's widths; tc<32, 128>
    (1, 2, 128, 16, 128, 64),      # tc<16, 128>
    (1, 140, 128, 50, 100, 64),    # tc<56, 128>
    (1, 140, 128, 64, 128, 64),    # tc<64, 128>, one stage
    (2, 3, 256, 16, 8, 128),       # a long chunk
    (6, 1, 64, 7, 5, 16),          # per-head b, c (G = BH), odd widths
    (1, 2, 96, 7, 5, 16),          # S not a multiple of the tile
    (1, 2, 96, 12, 6, 32),
    (1, 1, 32, 16, 8, 32),         # S under one tile
    (1, 2, 256, 100, 16, 64),      # P over 64: two slices
    (1, 2, 256, 32, 64, 64),       # N 64: tc<16, 64>
    (1, 2, 128, 40, 100, 64),      # N 100: the second row tile ragged
    (1, 3, 192, 56, 33, 64),       # N 33: two boxes; tc<32, 64>
]
TIMED = [  # tag, G, r, S, P, N, Q, model layout
    ("hymba", 2, 64, 4096, 50, 16, 64, False),
    ("model", 2, 64, 4096, 50, 16, 64, True),
    ("mamba2", 2, 32, 4096, 64, 128, 64, False),
    ("train_block", 8, 64, 256, 50, 16, 64, True),
    ("train_vmap4", 32, 64, 256, 50, 16, 64, True),
]
RTOL, ATOL = cs.LM_TOL["ssd"]


def inputs(gen, G, r, S, P, N, model):
    if model:
        xdt = torch.randn((G, S, r, P), generator=gen,
                          device="cuda").transpose(1, 2)
        la = -0.5 * torch.rand((G, S, r), generator=gen,
                               device="cuda").transpose(1, 2)
    else:
        xdt = torch.randn((G * r, S, P), generator=gen, device="cuda")
        la = -torch.rand((G * r, S), generator=gen, device="cuda")
    b = 0.3 * torch.randn((G, S, N), generator=gen, device="cuda")
    c = 0.3 * torch.randn((G, S, N), generator=gen, device="cuda")
    return xdt, la, b, c


def checks(gen):
    from repro_torch.kernels.ssd_scan import (kernel_plan, ssd_scan,
                                              ssd_scan_plain)
    for case in CASES:
        G, r, S, P, N, Q = case
        for model in (False, True):
            try:
                xdt, la, b, c = inputs(gen, G, r, S, P, N, model)
                ref = ssd_scan_plain(xdt, la, b, c, chunk=Q)
                y = ssd_scan(xdt, la, b, c, chunk=Q)
                again = ssd_scan(xdt, la, b, c, chunk=Q)
                torch.cuda.synchronize()
                err = (y - ref).abs()
                bad = err > ATOL + RTOL * ref.abs()
                extra = ""
                if model:
                    flat = ssd_scan(xdt.reshape(G * r, S, P).contiguous(),
                                    la.reshape(G * r, S).contiguous(), b, c,
                                    chunk=Q)
                    extra = (" view==contiguous "
                             f"{torch.equal(y.reshape(G * r, S, P), flat)}"
                             f" strides {y.stride() == xdt.stride()}")
                print("case", case, "model" if model else "flat", "plan",
                      kernel_plan(G, r, S, P, N), "maxerr", float(err.max()),
                      "nbad", int(bad.sum()), "of", bad.numel(), "finite",
                      bool(torch.isfinite(y).all()), "bitequal",
                      torch.equal(y, again), extra, flush=True)
                if bad.any():
                    idx = bad.nonzero()[:4].tolist()
                    print("  first bad (index, kernel, plain):",
                          [(i, float(y[tuple(i)]), float(ref[tuple(i)]))
                           for i in idx], flush=True)
            except Exception:
                traceback.print_exc()
    big = torch.zeros((1, 256, 256), device="cuda")
    try:
        ssd_scan(big, big[..., 0].contiguous(), big, big, chunk=256)
        print("refusal: N 256 ran, not refused", flush=True)
    except ValueError as exc:
        print("refusal: N 256 refused:", exc, flush=True)


def times(gen, label):
    from repro_torch.kernels.ssd_scan import ssd_scan
    rows = []
    for tag, G, r, S, P, N, Q, model in TIMED:
        xdt, la, b, c = inputs(gen, G, r, S, P, N, model)
        nbytes, flops = cs.ssd_cost(G, r, S, P, N, Q)
        try:
            ms = cs.graph_ms(torch, lambda: ssd_scan(xdt, la, b, c, chunk=Q))
            row = {"label": label, "case": tag, "kernel_ms": ms,
                   "bound_ms": cs.bound_ms(nbytes, flops,
                                           cs.F32_FLASH_FLOPS_PER_S),
                   "cuda_core_bound_ms": cs.bound_ms(nbytes, flops)}
            print("time", json.dumps(row), flush=True)
            rows.append(row)
        except Exception:
            traceback.print_exc()
        del xdt, la, b, c
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--time-only", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ssd_check: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build
    print(args.label, cs.card_line(), flush=True)
    t0 = time.time()
    lib = build.build("ssd_scan")
    print(f"built in {time.time() - t0:.1f} s", flush=True)
    print("\n".join(line for line in build.ptxas_report("ssd_scan")
                    .read_text().splitlines()
                    if "registers" in line or "spill" in line or "entry" in line
                    or "arning" in line or "rror" in line), flush=True)
    sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", str(lib)],
                          capture_output=True, text=True).stdout
    hgmma = [line for line in sass.splitlines() if "HGMMA" in line]
    print("HGMMA", len(hgmma), "of them TF32",
          sum(".TF32" in line for line in hgmma), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    if not args.time_only:
        checks(gen)
    rows = times(gen, args.label)
    print(json.dumps({"ssd_check": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
