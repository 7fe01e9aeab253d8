#!/usr/bin/env python3
"""Probe the grouped int8 fold's design choices on the card, in one call.

    python scripts/probe_fold_q8.py [--parent DIR]

The grouped int8 fold (``adel_agg_q8_grouped``, ``fold_grouped_q8_kernel``
in ``src/repro_torch/csrc/adel_agg.cu``) is built in variants, each a copy
of this checkout's ``src/repro_torch`` under ``build/probe_fold_q8/`` with
the source edited as the variant says:

* ``vecs1`` / ``vecs2``: 16-code vectors a thread owns in a row (the
  kernel's ``kVecsQ8`` and the wrapper's ``FOLD_VECS_Q8``);
* ``smem`` (as committed): a warp's outputs staged through shared memory
  (a swizzled 2 KB a warp), then stored fully coalesced;
* ``direct``: each thread stores its 64 bytes of f32 a vector as four
  16-byte stores (lanes 64 bytes apart);
* ``stcs``: the same stores as streaming stores (``__stcs``).

All variants are built at once (one ``nvcc`` each) and then timed in turns,
forward and back, each in a process of its own: the VGG-11 int8 round (38
leaves at full width, U=10) as CUDA-graph replays of 3 calls, beside the 38
per-leaf ``adel_agg_q8`` launches, and held against the plain version
(rtol 1e-5), with a 70-leaf table of stacked and scalar ids and ragged F
(two launches). Each prints ptxas's registers and spills of the kernel.

Then the wrappers' host cost (``call_ms``: CUDA events over 50 eager calls
of the round's fold, host-bound; the least and the median of 7 such
batches) of both grouped entries, with the block map memoised (as
committed) and with its cache cleared before each call (``cold``), in
turns, and, with ``--parent DIR`` (a tree unpacked with ``git archive``),
the parent's ``adel_agg_grouped``, in turns with this tree's. Prints the card's name and
power limit first. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "probe_fold_q8"

STAGED = """      if (f0 + ((long long)k * kThreads + (threadIdx.x | 31) + 1) * VN <= F) {
#pragma unroll
        for (int j = 0; j < VN / 4; ++j)
          st[lane * 4 + ((j + (lane >> 1)) & 3)] = pack16(acc[k] + 4 * j, float());
        __syncwarp();
        uint4* dw = d - lane * (VN / 4);            // the warp's first vector
#pragma unroll
        for (int i = 0; i < VN / 4; ++i) {
          const int m = i * 32 + lane;              // from lane m / 4
          dw[m] = st[(m & ~3) + (((m & 3) + (m >> 3)) & 3)];
        }
        __syncwarp();
        continue;
      }
"""
STAGE = """    __shared__ uint4 stage[kThreads / 32][32 * VN / 4];
    uint4* st = stage[threadIdx.x >> 5];
    const int lane = threadIdx.x & 31;
"""
DIRECT = "d[j] = pack16(acc[k] + 4 * j, float());"
# store variant -> (old, new) edits of the kernel as committed ("smem")
STORES = {
    "smem": [],
    "direct": [(STAGED, ""), (STAGE, "")],
    "stcs": [(STAGED, ""), (STAGE, ""),
             (DIRECT, "__stcs(d + j, pack16(acc[k] + 4 * j, float()));")],
}


def variant_tree(vecs: int, store: str) -> Path:
    """A copy of src/repro_torch with the variant's edits; returns its src."""
    src = OUT / f"vecs{vecs}-{store}" / "src"
    if src.exists():
        shutil.rmtree(src.parent)
    shutil.copytree(ROOT / "src" / "repro_torch", src / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = src / "repro_torch" / "csrc" / "adel_agg.cu"
    text = cu.read_text()
    text, n = re.subn(r"constexpr int kVecsQ8 = \d+;",
                      f"constexpr int kVecsQ8 = {vecs};", text)
    assert n == 1, "kVecsQ8 not found"
    for old, new in STORES[store]:
        assert text.count(old) == 1, f"{old!r} not found once"
        text = text.replace(old, new)
    cu.write_text(text)
    py = src / "repro_torch" / "kernels" / "adel_agg.py"
    text, n = re.subn(r"FOLD_VECS_Q8 = \d+", f"FOLD_VECS_Q8 = {vecs}",
                      py.read_text())
    assert n == 1, "FOLD_VECS_Q8 not found"
    py.write_text(text)
    return src


def child(src: str, label: str, host: bool) -> int:
    """Time one variant (imported from ``src``) on the card."""
    sys.path.insert(0, src)
    import importlib

    import torch

    from repro_torch.kernels import build
    ka = importlib.import_module("repro_torch.kernels.adel_agg")
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (U_MAIN, bound_ms, call_ms, graph_ms, q8_bytes,
                            quantize, vgg_leaf_features)
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build("adel_agg")
    report = build.ptxas_report("adel_agg").read_text()
    at = report.find("fold_grouped_q8_kernel")
    regs = re.findall(r"(\d+ bytes spill stores, \d+ bytes spill loads|"
                      r"Used \d+ registers)", report[at:at + 600])[:2]
    gen = torch.Generator(device="cuda").manual_seed(1)
    sizes = [F for F, n in vgg_leaf_features().items() for _ in range(n)]
    coeff = torch.rand((U_MAIN, len(sizes)), generator=gen, device="cuda")
    ids = list(range(len(sizes)))
    qs, ss, cs = [], [], []
    for k, F in enumerate(sizes):
        q, s = quantize(torch, torch.randn((U_MAIN, 1, F), generator=gen,
                                           device="cuda"))
        qs.append(q), ss.append(s), cs.append(coeff[:, k:k + 1].contiguous())
    if hasattr(ka, "adel_agg_q8_grouped"):
        fold = (lambda: ka.adel_agg_q8_grouped(qs, ss, ids, coeff))
        outs, refs = fold(), ka.adel_agg_q8_grouped_plain(qs, ss, ids, coeff)
        err = max(float((o - r).abs().max() / (1 + r.abs().max()))
                  for o, r in zip(outs, refs))
        # 70 leaves: stacked ids (a host range, or on the card), ragged F
        spec = [(1 + k % 3, [300, 7, 4096, 1000, 8, 2048][k % 6])
                for k in range(70)]
        q70, s70 = zip(*(quantize(torch, torch.randn(
            (U_MAIN, r, F), generator=gen, device="cuda")) for r, F in spec))
        i70 = [k % 40 if r == 1 else torch.arange(k % 7, k % 7 + r)
               if k % 2 else torch.randperm(40, device="cuda")[:r]
               for k, (r, F) in enumerate(spec)]
        c70 = torch.rand((U_MAIN, 40), generator=gen, device="cuda")
        err = max([err] + [float((o - r).abs().max() / (1 + r.abs().max()))
                           for o, r in zip(
                               ka.adel_agg_q8_grouped(list(q70), list(s70),
                                                      i70, c70),
                               ka.adel_agg_q8_grouped_plain(q70, s70, i70,
                                                            c70))])
        ms = graph_ms(torch, fold, reps=3, replays=20)
        per_leaf = graph_ms(torch, lambda: [ka.adel_agg_q8(q, s, c) for q, s, c
                                            in zip(qs, ss, cs)],
                            reps=3, replays=20)
        nbytes = sum(q8_bytes(U_MAIN, 1, F) for F in sizes)
        print(f"[{label}] q8 round ms={ms:.5f} per_leaf_ms={per_leaf:.5f} "
              f"bound_ms={bound_ms(nbytes, 2 * U_MAIN * sum(sizes)):.5f} "
              f"max_rel_err={err:.3e} {'ok' if err <= 1e-5 else 'FAIL'} "
              f"ptxas: {'; '.join(regs)}", flush=True)
        if err > 1e-5:
            return 1
    if host:
        grads = [torch.randn((U_MAIN, 1, F), generator=gen, device="cuda")
                 for F in sizes]
        fns = {"adel_agg_grouped": lambda: ka.adel_agg_grouped(grads, ids,
                                                                coeff)}
        if hasattr(ka, "adel_agg_q8_grouped"):
            fns["adel_agg_q8_grouped"] = fold
        for name, fn in fns.items():
            def cold(fn=fn):
                ka._fold_plan.cache_clear()
                return fn()
            # batches of 50 calls, memoised and cold in turns: the host is
            # shared, so the least batch and the median are printed
            runs = {"call_ms": fn}
            if hasattr(ka, "_fold_plan"):
                runs["cold_plan_call_ms"] = cold
            ms: dict = {k: [] for k in runs}
            for _ in range(7):
                for k, f in runs.items():
                    ms[k].append(call_ms(torch, f, iters=50, warmup=5))
            print(f"[{label}] host {name} " + " ".join(
                f"{k}=min {min(v):.5f} median {sorted(v)[3]:.5f}"
                for k, v in ms.items()), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="a parent tree, for its host cost")
    ap.add_argument("--child", nargs=2, metavar=("SRC", "LABEL"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--host", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(*args.child, args.host)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"[card] {card}", flush=True)
    variants = {f"vecs{v}-{s}": variant_tree(v, s)
                for v in (1, 2) for s in STORES}

    def build(src: Path):
        return subprocess.run(
            [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]);"
             " from repro_torch.kernels import build; build.build('adel_agg')",
             str(src)], capture_output=True, text=True)

    with ThreadPoolExecutor(len(variants)) as pool:
        for name, proc in zip(variants, pool.map(build, variants.values())):
            if proc.returncode:
                print(f"[{name}] build failed:\n{proc.stderr}", flush=True)
                return 1
    order = list(variants) + list(reversed(variants))
    rc = 0
    for name in order:
        rc |= subprocess.run([sys.executable, __file__, "--child",
                              str(variants[name]), name]).returncode
    runs = [(str(ROOT / "src"), "tree"), (str(ROOT / "src"), "tree")]
    if args.parent:
        runs = [(str(Path(args.parent) / "src"), "parent")] + runs + [
            (str(Path(args.parent) / "src"), "parent")]
    for src, label in runs:
        rc |= subprocess.run([sys.executable, __file__, "--child", src, label,
                              "--host"]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
