#!/usr/bin/env python3
"""Where the f32 flash kernel's time goes, on the card, in one call.

    python scripts/probe_flash_f32.py

The f32 flash kernel (``flash_fwd_kernel_tf32`` in
``src/repro_torch/csrc/flash_attention.cu``: 3xTF32 on ``wgmma``) is built
in variants, each a copy of this checkout's ``src/repro_torch`` under
``build/probe_flash_f32/`` with the source edited as the variant says:

* ``as_built``: the kernel as committed (held against the plain version,
  rtol = atol = 2e-5);
* ``no_split``: the split pass writes nothing (K and V^T stay as TMA left
  them; the V blocks are still read): the split pass's cost;
* ``one_product``: one tf32 ``wgmma`` a k-step in S = Q K^T and in
  O += P V instead of three: two thirds of the tensor-core work gone;
* ``one_product_no_split``: both.

Only ``as_built`` computes the attention; the others are timings. All
variants are built at once (one ``nvcc`` each) and timed in turns, forward
and back, each in a process of its own with a time limit, at the f32
shapes ``chip_smoke.py`` times, as CUDA-graph replays (device time), with
the 3xTF32 bound (495 / 3 TFLOP/s) beside each. Prints the card's name
and power limit first. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "probe_flash_f32"

SPLIT_K = "      split_tile(sm.k[s], sm.k_lo, BKT * HD, ct, 128 * kConsumers);\n"
SPLIT_V = """        *reinterpret_cast<float4*>(vbytes + off) = split4(col, lo);
        *reinterpret_cast<float4*>(vlo + off) = lo;
"""
QK3 = """        wgmma_ss(sc, desc(ql_base + qo, 16, 1024), desc(kh_base + ko, 16, 1024),
                 kk > 0);
        wgmma_ss(sc, desc(qh_base + qo, 16, 1024), desc(kl_base + ko, 16, 1024), 1);
        wgmma_ss(sc, desc(qh_base + qo, 16, 1024), desc(kh_base + ko, 16, 1024), 1);
"""
QK1 = """        wgmma_ss(sc, desc(qh_base + qo, 16, 1024), desc(kh_base + ko, 16, 1024),
                 kk > 0);
"""
PV_LO = """        wgmma_rs(acc, al, desc(vh_base + vo, 16, 1024));
        wgmma_rs(acc, ah, desc(vl_base + vo, 16, 1024));
"""
NO_SPLIT = [(SPLIT_K, ""), (SPLIT_V, "        if (kt < 0) {\n" + SPLIT_V + "        }\n")]
ONE_PRODUCT = [(QK3, QK1), (PV_LO, "")]
VARIANTS = {"as_built": [], "no_split": NO_SPLIT, "one_product": ONE_PRODUCT,
            "one_product_no_split": NO_SPLIT + ONE_PRODUCT}

CASES = [  # tag, B, H, KV, Sq, Sk, hd, causal, window (chip_smoke.py's f32)
    ("hymba", 2, 25, 5, 4096, 4096, 64, True, 1024),
    ("seamless_encoder", 2, 16, 16, 1024, 1024, 64, False, 0),
    ("seamless_decoder", 2, 16, 16, 4096, 4096, 64, True, 0),
    ("seamless_cross", 2, 16, 16, 4096, 1024, 64, False, 0),
    ("seamless_train_self", 2, 16, 16, 256, 256, 64, True, 0),
    ("seamless_train_cross", 2, 16, 16, 256, 1024, 64, False, 0),
    ("llava", 2, 56, 8, 3904, 3904, 128, True, 0),
    ("train_block", 8, 25, 5, 256, 256, 64, True, 1024),
]


def variant_tree(name: str) -> Path:
    """A copy of src/repro_torch with the variant's edits; returns its src."""
    src = OUT / name / "src"
    if src.exists():
        shutil.rmtree(src.parent)
    shutil.copytree(ROOT / "src" / "repro_torch", src / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = src / "repro_torch" / "csrc" / "flash_attention.cu"
    text = cu.read_text()
    for old, new in VARIANTS[name]:
        assert text.count(old) == 1, f"{old!r} not found once"
        text = text.replace(old, new)
    cu.write_text(text)
    return src


def child(src: str, label: str) -> int:
    """Time one variant (imported from ``src``) on the card."""
    sys.path.insert(0, src)
    import re

    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain,
                                                     visible_pairs)
    sys.path.insert(0, str(ROOT))
    from chip_smoke import bound_ms, graph_ms
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build("flash_attention")
    report = build.ptxas_report("flash_attention").read_text()
    regs = re.findall(r"tf32ILi(\d+)E.*?\n\s+(\d+) bytes stack frame, "
                      r"(\d+) bytes spill stores", report, re.S)
    gen = torch.Generator(device="cuda").manual_seed(3)
    for tag, B, H, KV, Sq, Sk, hd, causal, window in CASES:
        q = torch.randn((B, H, Sq, hd), generator=gen, device="cuda")
        k = torch.randn((B, KV, Sk, hd), generator=gen, device="cuda")
        v = torch.randn((B, KV, Sk, hd), generator=gen, device="cuda")

        def run():
            return flash_attention(q, k, v, causal=causal, window=window)

        err = None
        if label == "as_built":
            ref = flash_attention_plain(q, k, v, causal=causal, window=window)
            out = run()
            bad = (out - ref).abs() > 2e-5 + 2e-5 * ref.abs()
            err = float((out - ref).abs().max())
            if bool(bad.any()):
                print(f"[{label}] {tag} FAIL max_abs_err={err:.3e}", flush=True)
                return 1
        ms = graph_ms(torch, run, reps=5, replays=4)
        nbytes = (2 * B * H * Sq * hd + 2 * B * KV * Sk * hd) * 4
        flops = 4 * B * H * hd * visible_pairs(Sq, Sk, causal=causal,
                                               window=window)
        row = {"variant": label, "case": tag, "ms": ms,
               "tf32x3_bound_ms": bound_ms(nbytes, flops, 495e12 / 3),
               "max_abs_err": err}
        print(f"[{label}] {json.dumps(row)}", flush=True)
        del q, k, v
    print(f"[{label}] ptxas (hd, stack bytes, spill bytes): {regs}", flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--child", nargs=2, metavar=("SRC", "LABEL"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(*args.child)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"[card] {card}", flush=True)
    trees = {name: variant_tree(name) for name in VARIANTS}

    def build(src: Path):
        return subprocess.run(
            [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]);"
             " from repro_torch.kernels import build; build.build("
             "'flash_attention')", str(src)],
            capture_output=True, text=True, timeout=300)

    with ThreadPoolExecutor(max_workers=len(trees)) as pool:
        for name, proc in zip(trees, pool.map(build, trees.values())):
            if proc.returncode:
                print(f"[{name}] build failed:\n{proc.stderr[-3000:]}", flush=True)
                return 1
    order = list(trees) + list(trees)[::-1]
    fails = 0
    for name in order:
        try:
            proc = subprocess.run([sys.executable, __file__, "--child",
                                   str(trees[name]), name], timeout=240)
            fails += proc.returncode != 0
        except subprocess.TimeoutExpired:
            print(f"[{name}] timed out", flush=True)
            fails += 1
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
