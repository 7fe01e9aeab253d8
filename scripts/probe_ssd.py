#!/usr/bin/env python3
"""Probe where the SSD scan kernel's time goes, on the card, in one call.

    python scripts/probe_ssd.py [--parent DIR] [--only NAME,...]

The tensor-core SSD scan (``ssd_scan_tc`` in
``src/repro_torch/csrc/ssd_scan.cu``) is built in variants, each a copy of
this checkout's ``src/repro_torch`` under ``build/probe_ssd/<name>/`` with
the source edited as the variant says (each edit replaces every match in
the source, and must match at least once, or the probe stops). The
variants that drop work give wrong outputs and are timed only, to show
what each part costs:

* ``base``: as committed;
* ``no_loads``: no copy started (the ring's slots keep their zeros);
* ``no_split``: no split pass (X^T, B's hi/lo and (B o w)^T not written);
* ``no_g``: no wgmma of C B^T and the inter term;
* ``no_intra``: no wgmma of the intra term;
* ``no_state``: no state update's wgmma (a small state's; the one
  warpgroup kernel also skips a large state's update);
* ``no_mma``: no wgmma at all;
* ``no_fence``: no ``fence.proxy.async`` (the wgmmas may read stale
  tiles);
* ``no_ystore``: y not stored; ``no_hstore``: h^T not stored;
* ``no_ex2``: the exponent itself in place of ``ex2.approx``.

All variants are built at once (one ``nvcc`` each; ptxas's registers and
spills of each instantiation printed), then timed in turns, forward and
back, each in a process of its own, by ``scripts/ssd_check.py --src
<copy>/src --time-only`` (the main path's shapes as CUDA-graph replays,
under the kernel's own plan). ``--parent DIR`` (a tree unpacked with
``git archive``) times the parent's kernel in the same turns. Prints the
card's name and power limit first. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "probe_ssd"
HELPERS = "// The tile's log2(e) cumsum(la)"

VARIANTS = {
    "base": [],
    "no_loads": [
        ("if (t < nT) load_tile<PW>(", "if (false) load_tile<PW>("),
        ("if (tn < nT) load_tile<PW>(", "if (false) load_tile<PW>(")],
    "no_split": [
        ("for (int u = wt; u < PW * 16; u += kThreads) {",
         "for (int u = wt; u < 0; u += kThreads) {"),
        ("for (int u = wt; u < kT * (N8 / 4); u += kThreads) {",
         "for (int u = wt; u < 0; u += kThreads) {")],
    "no_g": [
        ("""      wgmma_rs(gacc, al[kk], desc(bh_u + bo));
      wgmma_rs(gacc, ah[kk], desc(blo_u + bo));
      wgmma_rs(gacc, ah[kk], desc(bh_u + bo));
      if (inter) {""", "      if (false) {")],
    "no_intra": [
        ("""    wgmma_rs(yacc, ml[j], desc(xth + xo));
    wgmma_rs(yacc, mh[j], desc(xtl + xo));
    wgmma_rs(yacc, mh[j], desc(xth + xo));""", "")],
    "no_state": [
        ("""    wgmma_ss(hacc, desc(xtl + xo), desc(bwh + bo));
    wgmma_ss(hacc, desc(xth + xo), desc(bwl + bo));
    wgmma_ss(hacc, desc(xth + xo), desc(bwh + bo));""", ""),
        ("if (t + 1 < nT) {                        // no state",
         "if (false) {                        // no state")],
    "no_mma": [(HELPERS, "#define wgmma_rs(...) ((void)0)\n"
                         "#define wgmma_ss(...) ((void)0)\n" + HELPERS)],
    "no_fence": [("fence_async_smem();", "")],
    "no_ystore": [("if (i >= valid || p >= sp.pc) continue;", "continue;")],
    "no_hstore": [("if (p >= PW || n >= N8) continue;", "continue;")],
    "no_ex2": [('asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));',
                "y = x;")],
}


def make(name: str, edits) -> Path:
    dst = OUT / name / "src"
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(ROOT / "src" / "repro_torch", dst / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = dst / "repro_torch" / "csrc" / "ssd_scan.cu"
    text = cu.read_text()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"{name}: edit matches nothing: {old[:60]!r}")
        text = text.replace(old, new)
    cu.write_text(text)
    return dst


def build(src: Path) -> str:
    code = ("from repro_torch.kernels import build; build.build('ssd_scan'); "
            "print(build.ptxas_report('ssd_scan').read_text())")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env={**os.environ,
                                          "PYTHONPATH": str(src)})
    if proc.returncode:
        return "BUILD FAILED\n" + proc.stderr[-3000:]
    return "\n".join(line for line in proc.stdout.splitlines()
                     if "registers" in line or "spill" in line
                     or "Compiling entry" in line)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None)
    ap.add_argument("--only", default=None)
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    names = args.only.split(",") if args.only else list(VARIANTS)
    srcs = {n: make(n, VARIANTS[n]) for n in names}
    with ThreadPoolExecutor(len(srcs)) as pool:
        reports = dict(zip(srcs, pool.map(build, srcs.values())))
    for name, rep in reports.items():
        print(f"[{name}] ptxas:\n{rep}", flush=True)
    runs = [(n, str(s)) for n, s in srcs.items() if "FAILED" not in reports[n]]
    if args.parent:
        runs.append(("parent", str(Path(args.parent) / "src")))
    rows = []
    for label, src in runs + runs[::-1]:
        proc = subprocess.run(
            [sys.executable, str(ROOT / "scripts" / "ssd_check.py"), "--src",
             src, "--label", label, "--time-only"], capture_output=True,
            text=True, timeout=300)
        for line in proc.stdout.splitlines():
            if line.startswith("time "):
                row = json.loads(line[5:])
                rows.append(row)
                print(f"[{label}] {row['case']:12s} {row['kernel_ms']:.5f} ms "
                      f"(bound {row['bound_ms']:.5f})", flush=True)
        if proc.returncode:
            print(f"[{label}] exit {proc.returncode}: {proc.stderr[-2000:]}",
                  flush=True)
    print(json.dumps({"probe_ssd": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
