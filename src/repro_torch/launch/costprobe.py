"""A full-depth dry-run count from reduced-depth probes (port of
``repro.launch.costprobe``).

The reference needs this module because XLA's ``HloCostAnalysis`` counts a
scan body once. The port has no scan: its dry run (``launch/dryrun.py``)
counts every block and every client op by op, and is exact at any depth.
But it traces about a millisecond an op, and a full-width ``train_4k``
temporal step (16 clients x L blocks, forward and backward) is minutes of
that. So the cost probe counts REDUCED-DEPTH steps and extrapolates
linearly, exact for homogeneous stacked blocks:

  prefill/decode:   C(l) = rest + l * per_layer
      probes l in {2, 4};  slope = (C4 - C2) / 2
      true = C4 + (L_total - 4) * slope

  train (temporal): C(U, l) = rest + a * l + U * (c + l * per_layer)
      probes (U, l) in {(2,2), (2,4), (4,4)} (the reference's) and (4,2)
      per_layer = (C(4,4) - C(4,2) - C(2,4) + C(2,2)) / 4
      a         = (C(2,4) - C(2,2)) / 2 - 2 * per_layer
      c         = (C(4,2) - C(2,2)) / 2 - 2 * per_layer
      rest      = C(2,2) - 2 * a - 2 * c - 4 * per_layer
      true      = rest + a . L* + U* . (c + L* . per_layer)

The reference's train model has no ``a * l`` term and fits three points.
The port's step has one: the server update and the output placements run
over every layer once a round, and the accumulator takes U - 1 adds of
every layer, not U. Three points cannot tell it from the clients' terms
(its error is a (U*/2 - 1)(L* - 4)), so a fourth point, (4, 2), makes the
bilinear fit exact. Every probe keeps the production per-client batch,
mesh, placements, remat and dtype; only the number of stacked blocks (and
of clients) shrinks. ``tests/test_torch_dryrun.py`` holds the
extrapolation to a full-depth count.

    PYTHONPATH=src python -m repro_torch.launch.costprobe --records experiments/dryrun_torch
    PYTHONPATH=src python -m repro_torch.launch.costprobe --records experiments/dryrun_torch_multipod --multi-pod
"""
from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import sys
import time

from repro_torch.configs import get_config, get_shape
from repro_torch.launch.mesh import batch_shards, make_production_mesh
from repro_torch.launch.specs import windowed_variant

__all__ = ["PROBE_LS", "TRAIN_PROBES", "probe_combo", "correct_records",
           "main"]

PROBE_LS = (2, 4)
_KEYS = ("flops", "bytes", "coll")


def _reduced_cfg(cfg, l: int):
    """Depth-l variant: decoder (and proportionally encoder) blocks."""
    enc = 0
    if cfg.enc_layers:
        enc = max(1, round(cfg.enc_layers * l / cfg.L))
    return dataclasses.replace(cfg, L=l, enc_layers=enc, unroll_layers=True)


def _cost_of(cfg, shape, mesh, *, mode, fsdp, remat):
    from repro_torch.launch.dryrun import run_combo
    t0 = time.perf_counter()
    rec = run_combo(cfg.name, shape.name, mode=mode, fsdp=fsdp, remat=remat,
                    mesh=mesh, cfg=cfg, shape=shape, verbose=False)
    return {"flops": float(rec["flops_per_device"]),
            "bytes": float(rec["bytes_per_device"]),
            "coll": float(rec["collective_bytes_per_device"]["total"]),
            "compile_s": round(time.perf_counter() - t0, 1),
            "meta": {k: rec[k] for k in ("U", "client_batch", "seq", "B",
                                         "cache_seq") if k in rec}}


def _lin2(c2, c4, l_target):
    """Linear extrapolation from depth-2/4 probes to depth l_target."""
    out = {}
    for k in _KEYS:
        slope = (c4[k] - c2[k]) / 2.0
        out[k] = c4[k] + (l_target - 4) * slope
    return out


TRAIN_PROBES = ((2, 2), (2, 4), (4, 4), (4, 2))


def _train_extrapolation(samples: dict, U_star: int, L_star: int) -> dict:
    """The bilinear fit of the four (U, l) probes at (U*, L*)."""
    out = {}
    for k in _KEYS:
        c22, c24, c44, c42 = (samples[f"U{u}_L{l}"][k]
                              for u, l in TRAIN_PROBES)
        per_layer = (c44 - c42 - c24 + c22) / 4.0
        a = (c24 - c22) / 2.0 - 2.0 * per_layer
        c_const = (c42 - c22) / 2.0 - 2.0 * per_layer
        rest = c22 - 2.0 * a - 2.0 * c_const - 4.0 * per_layer
        out[k] = rest + a * L_star + U_star * (c_const + L_star * per_layer)
    return out


def probe_combo(arch: str, shape_name: str, *, multi_pod: bool = False,
                mode: str = "temporal", attn_window: int = 0,
                fsdp: str | None = "data", remat: bool = True,
                cfg_overrides: dict | None = None, mesh=None, cfg=None,
                shape=None, verbose: bool = True) -> dict:
    """Return extrapolated per-device cost terms + raw probes for one
    combo. ``mesh``, ``cfg`` and ``shape`` (default: the production mesh
    and the registry's) as in ``dryrun.run_combo``."""
    cfg = cfg or get_config(arch)
    if attn_window:
        cfg = windowed_variant(cfg, attn_window)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = shape or get_shape(shape_name)
    if mesh is None:
        from repro_torch.launch.dryrun import open_world
        open_world(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod)

    if shape.kind == "train" and mode != "spatial":
        # production U/b for this mesh (as specs.build_dryrun temporal)
        U_star = max(shape.global_batch // batch_shards(mesh), 1)
        b_star = shape.global_batch // U_star
        samples = {}
        for (u, l) in TRAIN_PROBES:
            sh = dataclasses.replace(shape, global_batch=u * b_star)
            c = _cost_of(_reduced_cfg(cfg, l), sh, mesh, mode=mode,
                         fsdp=fsdp, remat=remat)
            samples[f"U{u}_L{l}"] = c
            if verbose:
                print(f"  [probe] {arch} {shape_name} U={u} l={l}: "
                      f"flops {c['flops']:.4g} traced {c['compile_s']}s",
                      flush=True)
        out = _train_extrapolation(samples, U_star, cfg.L)
        probes = {"kind": "train", "U_star": U_star, "L_star": cfg.L,
                  "samples": samples}
    else:
        # prefill/decode, and spatial-mode train, where the clients are a
        # vmap batch dim: depth probes alone reconstruct the costs
        cs = {}
        for l in PROBE_LS:
            c = _cost_of(_reduced_cfg(cfg, l), shape, mesh, mode=mode,
                         fsdp=fsdp, remat=remat)
            cs[l] = c
            if verbose:
                print(f"  [probe] {arch} {shape_name} l={l}: "
                      f"flops {c['flops']:.4g} traced {c['compile_s']}s",
                      flush=True)
        out = _lin2(cs[2], cs[4], cfg.L)
        probes = {"kind": shape.kind, "mode": mode, "L_star": cfg.L,
                  "samples": {f"L{l}": c for l, c in cs.items()}}

    out = {k: max(v, 0.0) for k, v in out.items()}
    return {"corrected": out, "probes": probes}


def correct_records(records_dir: str, *, multi_pod: bool,
                    only: str | None = None) -> int:
    """Rewrite each dry-run JSON with the probes' extrapolated roofline
    terms."""
    from repro_torch.launch.dryrun import HBM_BW, ICI_BW, PEAK_FLOPS
    n_fail = 0
    for fn in sorted(glob.glob(os.path.join(records_dir, "*.json"))):
        with open(fn) as f:
            rec = json.load(f)
        if "error" in rec:
            continue
        if only and only not in fn:
            continue
        arch, shape_name = rec["arch"], rec["shape"]
        attn_window = 0
        if arch.endswith("-swa4096"):
            arch, attn_window = arch[:-len("-swa4096")], 4096
        try:
            res = probe_combo(arch, shape_name, multi_pod=multi_pod,
                              mode=rec.get("mode", "temporal"),
                              attn_window=attn_window)
        except Exception as e:  # pragma: no cover
            print(f"[costprobe] FAIL {arch} x {shape_name}: {e}",
                  file=sys.stderr, flush=True)
            n_fail += 1
            continue
        corr = res["corrected"]
        rec["roofline_raw"] = rec.get("roofline_raw", rec["roofline"])
        rec["flops_per_device_raw"] = rec.get(
            "flops_per_device_raw", rec["flops_per_device"])
        rec["flops_per_device"] = corr["flops"]
        rec["bytes_per_device"] = corr["bytes"]
        rec["collective_bytes_per_device_total"] = corr["coll"]
        roof = {"compute_s": corr["flops"] / PEAK_FLOPS,
                "memory_s": corr["bytes"] / HBM_BW,
                "collective_s": corr["coll"] / ICI_BW}
        roof["dominant"] = max(("compute_s", "memory_s", "collective_s"),
                               key=lambda k: roof[k])
        rec["roofline"] = roof
        rec["cost_probes"] = res["probes"]
        with open(fn, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"[costprobe] {arch} x {shape_name} x {rec['mesh']}: "
              f"flops/dev {corr['flops']:.4g} bytes/dev {corr['bytes']:.4g} "
              f"coll/dev {corr['coll']:.4g} dominant={roof['dominant']}",
              flush=True)
    return n_fail


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--records", required=True,
                    help="directory of dry-run JSONs to correct in place")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--only", default=None,
                    help="substring filter on record filenames")
    args = ap.parse_args(argv)
    return 1 if correct_records(args.records, multi_pod=args.multi_pod,
                                only=args.only) else 0


if __name__ == "__main__":
    raise SystemExit(main())
