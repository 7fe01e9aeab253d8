"""The port's dry-run checks that need a fake process group, run in a
process of their own (process-group state is global, and the suite's
workers run many files): ``python tests/_torch_dryrun_worker.py PART OUT
RECORDS`` writes one JSON of results to OUT: PART ``counts`` the hand
counts, placements, errors and the cost probe's extrapolation; PART
``records`` the dry-run records of ``dryrun.main`` under RECORDS; PART
``one_by_one`` the 1 x 1 counts. The three parts run at once. Imports only ``torch`` and ``repro_torch``;
``tests/test_torch_dryrun.py`` holds the results to hand counts, to
``FlopCounterMode`` and to the reference.
"""
from __future__ import annotations

import dataclasses
import json
import sys

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import costprobe, dryrun
from repro_torch.launch.mesh import PartitionSpec as P
from repro_torch.launch.mesh import make_production_mesh, placements
from repro_torch.launch.specs import build_client_probe, build_dryrun
from repro_torch.models import transformer as tr
from repro_torch.tree import tree_leaves

# a reduced homogeneous arch (dense GQA), deeper than the probes
ARCH = "qwen1.5-4b"
DEPTH = 5


def _hand_counts(mesh) -> dict:
    """Counts of small ops on the 2 x 2 mesh, each run on its own."""
    from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                          distribute_tensor)
    f32 = torch.float32
    out = {}

    def count(fn, weights=(), fsdp_dims=()):
        c, res, _ = dryrun.count_step(fn, (), weights=weights,
                                      fsdp_dims=fsdp_dims)
        return {"products": c.products, "elementwise": c.elementwise,
                "bytes": c.bytes, "coll": c.collectives(),
                "local_shape": list(res.to_local().shape)}

    x = distribute_tensor(torch.empty((8, 16), dtype=f32, device="meta"),
                          mesh, [Shard(0), Replicate()])
    w = distribute_tensor(torch.empty((16, 32), dtype=f32, device="meta"),
                          mesh, [Replicate(), Shard(1)])
    # (8, 16) batch-sharded over data @ (16, 32) column-sharded over model
    out["product"] = count(lambda: x @ w)
    out["elementwise"] = count(lambda: x * 2.0)
    # the same product against a weight also sharded over data (fsdp):
    # gathered along data first (ZeRO-3)
    w2 = distribute_tensor(torch.empty((16, 32), dtype=f32, device="meta"),
                           mesh, [Shard(0), Shard(1)])
    out["fsdp_product"] = count(lambda: x @ w2, weights=[w2], fsdp_dims=(0,))
    # known redistributions of the (8, 16) f32 x
    out["gather"] = count(lambda: x.redistribute(mesh, [Replicate(),
                                                        Replicate()]))
    out["all_to_all"] = count(lambda: x.redistribute(mesh, [Shard(1),
                                                            Replicate()]))
    part = DTensor.from_local(torch.empty((8, 16), dtype=f32, device="meta"),
                              mesh, [Replicate(), Partial()])
    out["reduce"] = count(lambda: part.redistribute(mesh, [Replicate(),
                                                           Replicate()]))
    return out


def _placements(mesh) -> dict:
    from torch.distributed.tensor import distribute_tensor
    t = torch.empty((8, 6, 4), device="meta")
    cases = {"dims": P(None, "data", "model"), "tuple": P(("data", "model")),
             "none": P(), "model_first": P("model", None, "data")}
    res = {}
    for name, spec in cases.items():
        pl = placements(spec, mesh)
        res[name] = {"placements": [str(p) for p in pl],
                     "local": list(distribute_tensor(t, mesh, pl)
                                   .to_local().shape)}
    return res


def _one_by_one_vs_flop_counter() -> dict:
    """A reduced step counted on a 1 x 1 mesh against ``FlopCounterMode``
    over the same step run on the CPU."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch import steps as st
    mesh = dryrun.make_mesh((1, 1), ("data", "model"))
    cfg = dataclasses.replace(get_config(ARCH).reduced(), L=2)
    res = {}
    for kind, shape in (("prefill", InputShape("p", 16, 2, "prefill")),
                        ("train", InputShape("t", 16, 4, "train"))):
        rec = dryrun.run_combo(cfg.name, shape.name, mesh=mesh, cfg=cfg,
                               shape=shape, remat=False, verbose=False,
                               detail=True)
        gen = torch.Generator().manual_seed(0)
        if kind == "prefill":
            params = tr.init_params(gen, cfg, dtype=torch.bfloat16,
                                    device="cpu")
            args = (params, torch.randint(0, cfg.vocab, (2, 16),
                                          generator=gen))
            step = st.make_prefill_step(cfg)
        else:
            U, b, S = rec["U"], rec["client_batch"], rec["seq"]
            params = tr.init_params(gen, cfg, device="cpu")
            tok = torch.randint(0, cfg.vocab, (U, b, S), generator=gen)
            L = cfg.n_blocks_total
            args = (params, tok, tok, torch.ones((U, L)),
                    torch.full((L,), 0.05), torch.tensor(0.1))
            step = st.make_train_step(cfg, U=U, remat=False)
        with FlopCounterMode(display=False) as fc:
            step(*args)
        arg_bytes = sum(t.nbytes for t in tree_leaves(args[0])) + sum(
            a.nbytes for a in args[1:])
        res[kind] = {"products": rec["detail"]["flops_by_kind"]["products"],
                     "flop_counter": fc.get_total_flops(),
                     "argument_bytes": rec["memory"]["argument_size_in_bytes"],
                     "cpu_argument_bytes": arg_bytes,
                     "collectives": rec["collective_bytes_per_device"]}
    return res


def _extrapolation(mesh) -> dict:
    """``costprobe`` against a full-depth count of the same reduced arch,
    prefill and temporal training (U* = 3 clients, L* = DEPTH)."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(), L=DEPTH)
    res = {}
    for kind, shape in (("prefill", InputShape("p", 16, 8, "prefill")),
                        ("train", InputShape("t", 16, 6, "train"))):
        full = dryrun.run_combo(cfg.name, shape.name, mesh=mesh, cfg=cfg,
                                shape=shape, remat=False, verbose=False)
        probe = costprobe.probe_combo(cfg.name, shape.name, mesh=mesh,
                                      cfg=cfg, shape=shape, remat=False,
                                      verbose=False)
        res[kind] = {"full": {"flops": full["flops_per_device"],
                              "bytes": full["bytes_per_device"],
                              "coll": full["collective_bytes_per_device"][
                                  "total"]},
                     "probe": probe["corrected"],
                     "U": full.get("U"), "L": cfg.L}
    return res


def _client_probe(mesh) -> dict:
    """``build_client_probe`` (one client's weighted gradient,
    ``make_client_grad``) counted beside the temporal train step it is the
    body of: the step's products are U times the probe's (the update and
    the accumulator's adds are elementwise)."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(), L=2)
    shape = InputShape("t", 16, 6, "train")
    step = dryrun.run_combo(cfg.name, "t", mesh=mesh, cfg=cfg, shape=shape,
                            remat=False, verbose=False, detail=True)
    fn, args, _, out_pl = build_client_probe(
        cfg, shape, mesh, U=step["U"], b=step["client_batch"], remat=False)
    c, _, _ = dryrun.count_step(fn, args, weights=tree_leaves(args[0]),
                                fsdp_dims=(0,), out_placements=out_pl)
    return {"U": step["U"],
            "step_products": step["detail"]["flops_by_kind"]["products"],
            "probe_products": c.products}


def _errors(mesh) -> dict:
    """The reference's ValueErrors from ``build_dryrun``, and the production
    mesh's on a world of another size."""
    out = {}
    for name, cfg, shape in (
            ("long_500k", get_config("yi-6b"),
             InputShape("long_500k", 524_288, 1, "decode")),
            ("indivisible", get_config(ARCH).reduced(),
             InputShape("t", 16, 6, "train"))):
        try:
            build_dryrun(cfg, shape, mesh, U=6 if name == "indivisible"
                         else None)
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    try:                               # a world of 4 ranks, not 256
        make_production_mesh()
        out["production_mesh"] = None
    except ValueError as e:
        out["production_mesh"] = str(e)
    return out


def main(part: str, out_path: str, records: str) -> None:
    torch.set_num_threads(1)
    if part == "counts":
        mesh = dryrun.make_mesh((2, 2), ("data", "model"))
        res = {"hand": _hand_counts(mesh), "placements": _placements(mesh),
               "errors": _errors(mesh), "client_probe": _client_probe(mesh),
               "extrapolation": _extrapolation(mesh)}
    elif part == "records":
        for sh, mode in (("prefill_32k", "temporal"),
                         ("decode_32k", "temporal"),
                         ("train_4k", "temporal"), ("train_4k", "spatial")):
            rc = dryrun.main(["--arch", ARCH, "--shape", sh, "--mode", mode,
                              "--mesh", "2x2", "--reduced", "--no-remat",
                              "--seq", "16", "--batch", "8",
                              "--out", f"{records}/{mode}"])
            assert rc == 0, (sh, mode)
        res = {}
    else:
        res = {"one_by_one": _one_by_one_vs_flop_counter()}
    with open(out_path, "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    main(*sys.argv[1:4])
