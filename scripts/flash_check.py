#!/usr/bin/env python3
"""Quick check of the flash attention kernels on the card (~25 s).

    python scripts/flash_check.py

Builds ``csrc/flash_attention.cu`` and prints ptxas's report and the
library's count of ``HGMMA`` and ``UTMALDG`` SASS instructions; runs each
case of the flash list of ``tests/test_torch_gpu.py`` in bf16 and f32
against ``flash_attention_plain`` (rtol 1e-2 / atol 1e-3 in bf16, 2e-5 in
f32), then ``gqa_flash`` on (B, S, H, hd) tensors; and times hymba-1.5b's
and yi-6b's prefill shapes in bf16 against ``scaled_dot_product_attention``
with CUDA events over 20 eager calls after 3 of warm-up. Failing cases are
printed, not raised: this is the first, short call after a change to the
kernel, before ``chip_smoke.py``. Needs a CUDA device.
"""
import subprocess
import sys
import time
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

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
]


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


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_check: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain,
                                                     visible_mask)
    from repro_torch.kernels.ops import gqa_flash
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    t0 = time.time()
    lib = build.build("flash_attention")
    print(f"built in {time.time() - t0:.1f} s", flush=True)
    print(build.ptxas_report("flash_attention").read_text(), flush=True)
    sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", str(lib)],
                          capture_output=True, text=True).stdout
    print("HGMMA", sass.count("HGMMA"), "UTMALDG", sass.count("UTMALDG"),
          flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.bfloat16, torch.float32):
        rtol, atol = (1e-2, 1e-3) if dtype == torch.bfloat16 else (2e-5, 2e-5)
        for B, H, KV, Sq, Sk, hd, causal, window in CASES:
            try:
                q = torch.randn((B, H, Sq, hd), generator=gen, device="cuda").to(dtype)
                k = torch.randn((B, KV, Sk, hd), generator=gen, device="cuda").to(dtype)
                v = torch.randn((B, KV, Sk, hd), generator=gen, device="cuda").to(dtype)
                out = flash_attention(q, k, v, causal=causal, window=window)
                torch.cuda.synchronize()
                ref = flash_attention_plain(q, k, v, causal=causal, window=window)
                err = (out.float() - ref.float()).abs()
                bad = err > atol + rtol * ref.float().abs()
                print(dtype, (B, H, KV, Sq, Sk, hd, causal, window), "maxerr",
                      float(err.max()), "nbad", int(bad.sum()), "of",
                      bad.numel(), "finite",
                      bool(torch.isfinite(out.float()).all()), flush=True)
            except Exception:
                traceback.print_exc()
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

    for B, H, KV, S, hd, causal, window in [(2, 25, 5, 4096, 64, True, 1024),
                                            (2, 32, 4, 2048, 128, True, 0)]:
        q = torch.randn((B, H, S, hd), generator=gen, device="cuda").bfloat16()
        k = torch.randn((B, KV, S, hd), generator=gen, device="cuda").bfloat16()
        v = torch.randn((B, KV, S, hd), generator=gen, device="cuda").bfloat16()
        mask = visible_mask(S, S, causal, window, "cuda") if window else None
        kernel = events_ms(lambda: flash_attention(q, k, v, causal=causal,
                                                   window=window))
        sdpa = events_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=True))
        print("time", (B, H, KV, S, hd, causal, window), "kernel_ms", kernel,
              "sdpa_ms", sdpa, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
