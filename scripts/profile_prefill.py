#!/usr/bin/env python3
"""Profile one full-width hymba-1.5b prefill on the card, kernel by kernel.

    python scripts/profile_prefill.py [--src DIR] [--label NAME]

Imports ``repro_torch`` from ``--src`` (default: this checkout's ``src``),
so two trees can be compared in one run on one card, e.g. a parent commit
unpacked with ``git archive`` and this one, in turns. Builds the model
(all 32 blocks, bf16, random weights from a seed), runs 2 x 4096 random
prompt tokens through ``make_prefill_step`` once to warm up, then:

* times three more prefills (host clock around a synchronized call);
* profiles one with ``torch.profiler``: wall, device busy time, idle
  share, device kernel launches in all, and every copy kernel (a key with
  ``copy``) with its launches and time, then the top kernels;
* times ``flash_attention`` alone at the prefill's shape (B 2, H 25, KV 5,
  S 4096, hd 64, window 1024) in bf16 and f32, and ``ssd_scan`` alone at
  its shape (B 2, 64 heads, S 4096, P 50, N 16, contiguous inputs), with
  CUDA events over 20 eager calls after 3 of warm-up.

Prints the card's name and power limit first. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()
    sys.path.insert(0, args.src)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer as tr

    if not torch.cuda.is_available():
        print("profile_prefill: no CUDA device", file=sys.stderr)
        return 2
    tag = f"[{args.label}]"
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"{tag} card {card}; src {args.src}", flush=True)

    cfg = get_config("hymba-1.5b")
    B, S = 2, 4096
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = tr.init_params(gen, cfg, dtype=torch.bfloat16, device="cuda")
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen, device="cuda")
    step = make_prefill_step(cfg)
    step(params, tokens)
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        step(params, tokens)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    wall = sorted(walls)[1]
    print(f"{tag} prefill wall_ms={[round(w, 3) for w in walls]} median="
          f"{wall:.3f} tok_per_s={B * S / wall * 1e3:.1f}", flush=True)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, tokens)
        torch.cuda.synchronize()
        prof_wall = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    flash = sum(e.self_device_time_total for e in kernels
                if "flash_fwd_kernel" in e.key) / 1e3
    ssd = [e for e in kernels if "ssd_scan" in e.key]
    print(f"{tag} profile wall_ms={prof_wall:.3f} device_busy_ms={busy:.3f} "
          f"idle_share={1 - busy / prof_wall:.4f} launches="
          f"{sum(e.count for e in kernels)} flash_ms={flash:.3f} ssd_ms="
          f"{sum(e.self_device_time_total for e in ssd) / 1e3:.3f} "
          f"ssd_launches={sum(e.count for e in ssd)}", flush=True)
    for e in sorted(kernels, key=lambda e: -e.count):
        if "copy" in e.key:
            print(f"{tag}   copy x{e.count:<5d} "
                  f"{e.self_device_time_total / 1e3:8.3f} ms {e.key[:160]}",
                  flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"{tag}   top  x{e.count:<5d} "
              f"{e.self_device_time_total / 1e3:8.3f} ms {e.key[:160]}",
              flush=True)
    del params, tokens

    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn((2, 25, 4096, 64), generator=gen, device="cuda").to(dtype)
        k = torch.randn((2, 5, 4096, 64), generator=gen, device="cuda").to(dtype)
        for _ in range(3):
            flash_attention(q, k, k, window=1024)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            flash_attention(q, k, k, window=1024)
        end.record()
        torch.cuda.synchronize()
        print(f"{tag} flash_attention hymba {dtype} "
              f"ms={start.elapsed_time(end) / 20:.5f}", flush=True)
    from repro_torch.kernels.ssd_scan import ssd_scan
    xdt = torch.randn((128, 4096, 50), generator=gen, device="cuda")
    la = -0.5 * torch.rand((128, 4096), generator=gen, device="cuda")
    b = 0.3 * torch.randn((2, 4096, 16), generator=gen, device="cuda")
    for _ in range(3):
        ssd_scan(xdt, la, b, b)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        ssd_scan(xdt, la, b, b)
    end.record()
    torch.cuda.synchronize()
    print(f"{tag} ssd_scan hymba ms={start.elapsed_time(end) / 20:.5f}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
