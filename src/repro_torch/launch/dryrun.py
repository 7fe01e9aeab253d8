"""Dry run on the production mesh: run every (architecture x input-shape x
mesh) step once on ``meta`` DTensors over a fake process group and count
what rank 0 does (port of ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape prefill_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape decode_32k --multi-pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out experiments/dryrun_torch

No card and no memory is needed: the process opens its own world of 256
(or 512) ranks over ``torch.distributed``'s fake backend (the reference's
``--xla_force_host_platform_device_count=512``), lays the (16, 16) or (2,
16, 16) ``DeviceMesh`` over it, places the params, caches and batches as
``meta`` DTensors (``launch/specs.py``), and runs the step op by op.
:class:`CostCounter` sees each DTensor op after DTensor has turned it into
rank 0's local ops and collectives, and counts:

* FLOPs per device: ``torch.utils.flop_counter``'s formula for each product
  (the ops ``FlopCounterMode`` counts), plus one a value for elementwise
  ops (their outputs) and reductions (their inputs), as XLA's
  ``HloCostAnalysis`` counts them, on rank 0's local shapes;
* bytes per device: the local input and output bytes of each op that is
  not a view, unfused (as XLA's ``bytes accessed``);
* collective bytes per device: the output bytes of each
  ``_c10d_functional`` collective (already local), by kind, in the
  reference's ``{kind: bytes, "total", "count"}`` form;
* ``memory``: the local shards' bytes of the arguments and outputs.
  ``temp_size_in_bytes`` and ``generated_code_size_in_bytes`` are null: no
  buffer is assigned and no code generated on ``meta``.

The port runs its blocks as a Python loop, not a scan, so the count covers
every block and every client: ``--unroll`` is accepted and recorded and
changes nothing (``launch/costprobe.py`` extrapolates the same count from
reduced depths, which takes seconds where a full-width train step takes
minutes). The kernels' wrappers compute their plain versions' shapes on
``meta``: the attention is counted as the full Sq x Sk product, causal or
not, as the reference counts its jnp attention.

``torch.testing._internal.distributed.fake_pg`` is private to PyTorch; it
is imported here alone, and a torch without it fails here, saying so.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import sys
import time
import weakref
from unittest import mock

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _leaves
from torch.utils._pytree import tree_map
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ARCHS, INPUT_SHAPES, get_config, get_shape
from repro_torch.launch.mesh import make_production_mesh, mesh_chips
from repro_torch.launch.specs import (build_dryrun, local_bytes,
                                      windowed_variant)

__all__ = ["PEAK_FLOPS", "HBM_BW", "ICI_BW", "CostCounter", "open_world",
           "make_mesh", "count_step", "roofline", "run_combo", "iter_combos",
           "main"]

# NVIDIA H100 SXM5 80GB HBM3 at 700 W, from its data sheet (the card
# chip_smoke.py runs on):
PEAK_FLOPS = 989e12          # bf16 dense tensor-core FLOP/s
HBM_BW = 3.35e12             # HBM3 bytes/s
# a 16-wide mesh axis spans two 8-GPU NVLink nodes, so its collectives run
# at the inter-node rate: NDR InfiniBand, 400 Gb/s a GPU = 50 GB/s (not
# NVLink's 450 GB/s a direction)
ICI_BW = 50e9                # bytes/s per GPU

# the reference's collective kinds (HLO op names)
_COLL_KIND = {"all_gather_into_tensor": "all-gather",
              "all_gather_into_tensor_coalesced": "all-gather",
              "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
              "reduce_scatter_tensor": "reduce-scatter",
              "reduce_scatter_tensor_coalesced": "reduce-scatter",
              "all_to_all_single": "all-to-all", "broadcast": "broadcast"}
_NOT_COLL = ("wait_tensor", "_wrap_tensor_autograd")
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "prod", "var",
               "std", "logsumexp", "_log_softmax", "_softmax", "cumsum",
               "argmax", "argmin", "norm", "linalg_vector_norm", "any",
               "all"}
_UNEVEN = re.compile(r"not evenly divisible by mesh dimension (\d+)")
_NO_BYTES = {"empty", "empty_strided", "empty_like", "new_empty",
             "new_empty_strided"}


def _fake_pg():
    try:
        from torch.testing._internal.distributed import fake_pg
    except ImportError as e:      # pragma: no cover - depends on the torch
        raise RuntimeError(
            "the dry run needs torch.testing._internal.distributed.fake_pg "
            f"(torch {torch.__version__} has none): {e}") from e
    return fake_pg


def open_world(world_size: int) -> None:
    """This process as rank 0 of a fake world of ``world_size`` ranks: no
    rank runs but this one and no collective moves data. A fake world of
    another size is closed first; a real one raises."""
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a real process group is initialized; the "
                               "dry run opens its own fake one")
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=_fake_pg().FakeStore(), rank=0,
                            world_size=world_size)


def make_mesh(shape: tuple, axes: tuple):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over a fake world of
    its size (a (1, 1) mesh for one card, a (2, 2) one for the tests)."""
    from torch.distributed.device_mesh import init_device_mesh
    n = 1
    for s in shape:
        n *= s
    open_world(n)
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(axes))


class CostCounter(TorchDispatchMode):
    """Counts rank 0's local work: each DTensor op is handed back to
    DTensor, which runs it as local ops and collectives on the local
    shards, and those come back here. Only ops on ``meta`` tensors count:
    DTensor's sharding propagation runs ops on fake global tensors of the
    mesh's device, which are not work.

    Three rules stand in for what GSPMD does by itself on the reference's
    mesh, each a collective that is counted:

    * ZeRO-3: a weight (a DTensor of ``weights``, or one made from weights
      alone: a layer's view, a cast) is gathered along the ``fsdp_dims``
      mesh dims where it meets an activation, so the product runs on the
      activation's batch shard against the weight's tensor-parallel shard;
    * DTensor cannot view a dim sharded over a mesh dim into heads that
      mesh dim does not divide (hymba's 25 heads of 64 over ``model`` =
      16: 1600 values divide, 25 heads do not); then the op's inputs are
      gathered along that mesh dim first (GSPMD pads such a dim instead).
      An op DTensor refuses for another reason (chatglm3-6b's decode
      attention over 2 KV heads) has its inputs gathered one mesh dim at a
      time, the innermost first, until DTensor takes it; one DTensor still
      cannot place, or whose output spec comes out malformed (torch
      2.11's padding of the SSD conv input), runs on every rank's whole
      inputs, its output replicated. ``regathered`` counts these ops by
      name;
    * a lookup into a table sharded over its rows (``F.embedding`` over the
      vocab shards) holds partial values and a mask that DTensor applies,
      and drops, at the first reduction, so a second reader would find
      none: it is reduced at once, the all-reduce the lookup costs.
    """

    def __init__(self, weights=(), fsdp_dims=()):
        super().__init__()
        self.products = 0
        self.elementwise = 0
        self.bytes = 0
        self.ops = 0
        self.coll: dict = {}
        self.coll_count = 0
        self.coll_by_op: dict = {}
        self.regathered: dict = {}
        self._weights: dict = {}
        for t in weights:
            self._mark(t)
        self.fsdp_dims = tuple(fsdp_dims)
        self._op = "step"
        self._handing_over = False

    def _dtensor_op(self, func, args, kwargs):
        """Hand a DTensor op to DTensor with this mode pushed again, so its
        local ops come back here, after the rules above."""
        outer, self._op = self._op, func._overloadpacket.__name__
        try:
            dts = [t for t in _leaves((args, kwargs)) if isinstance(t, DTensor)]
            weight = [self._is_weight(t) for t in dts]
            if any(weight) and not all(weight) and self.fsdp_dims:
                args, kwargs = tree_map(
                    lambda t: self._gather(t, self.fsdp_dims)
                    if isinstance(t, DTensor) and self._is_weight(t) else t,
                    (args, kwargs))
            out = self._dispatch(func, args, kwargs)
            if dts and all(weight):
                for t in _leaves(out):
                    if isinstance(t, DTensor):
                        self._mark(t)
            return out
        finally:
            self._op = outer

    def collective(self, kind: str, nbytes: int) -> None:
        """Count one collective of ``kind`` whose output is ``nbytes`` on
        this rank."""
        self.coll[kind] = self.coll.get(kind, 0) + nbytes
        key = f"{self._op}: {kind}"
        self.coll_by_op[key] = self.coll_by_op.get(key, 0) + nbytes
        self.coll_count += 1

    def all_to_all(self, input, gather_dim, shard_dim, mesh, mesh_dim):
        """DTensor's Shard(i) -> Shard(j) redistribution: an all-to-all,
        which a mesh of the CPU's device type runs as an all-gather and a
        chunk (gloo has no all-to-all); counted as the all-to-all NCCL
        runs on the cards, its output this rank's chunk."""
        n = mesh.size(mesh_dim)
        shape = list(input.shape)
        shape[gather_dim] *= n
        shape[shard_dim] = -(-shape[shard_dim] // n)
        out = input.new_empty(shape)
        self.collective("all-to-all", out.nbytes)
        return out

    def _mark(self, t) -> None:
        # by identity (a WeakSet would compare tensors by value)
        self._weights[id(t)] = weakref.ref(t)

    def _is_weight(self, t) -> bool:
        ref = self._weights.get(id(t))
        return ref is not None and ref() is t

    def _gather(self, t, dims):
        """``t`` with its shards along mesh ``dims`` gathered (counted)."""
        if all(t.placements[d].is_replicate() for d in dims):
            return t
        pl = list(t.placements)
        for d in dims:
            pl[d] = Replicate()
        with self:
            return _redistribute(t, pl)

    def _dispatch(self, func, args, kwargs):
        dts = [t for t in _leaves((args, kwargs)) if isinstance(t, DTensor)]
        mesh_dims = list(range(dts[0].device_mesh.ndim)) if dts else []
        while True:
            self._handing_over = True
            try:
                with self:
                    out = func(*args, **kwargs)
                if all(len(t.placements) == t.device_mesh.ndim
                       for t in _leaves(out) if isinstance(t, DTensor)):
                    return tree_map(self._reduced, out)
                refusal = None          # a malformed output spec
            except (RuntimeError, IndexError) as e:
                # DTensor refused the op, or, in some torch versions, its
                # redistribution planner failed on it (an IndexError)
                refusal = e
            self._handing_over = False
            name = func._overloadpacket.__name__
            self.regathered[name] = self.regathered.get(name, 0) + 1
            m = None if refusal is None else _UNEVEN.search(str(refusal))
            if m is not None:
                dim = int(m.group(1))
            else:   # another refusal: gather the innermost dim left
                left = [d for d in mesh_dims if any(
                    not t.placements[d].is_replicate() for t in dts)]
                if not left or not isinstance(refusal, RuntimeError):
                    return self._replicated(func, args, kwargs)
                dim = left[-1]
            args, kwargs = tree_map(
                lambda t: self._gather(t, (dim,))
                if isinstance(t, DTensor) else t, (args, kwargs))
            dts = [t for t in _leaves((args, kwargs))
                   if isinstance(t, DTensor)]

    def _replicated(self, func, args, kwargs):
        """The op on every rank's whole inputs: its DTensor args gathered
        along every mesh dim (counted), the op run on their local tensors
        (counted), its outputs replicated. The last resort for an op
        DTensor cannot place."""
        from torch.distributed.tensor._dtensor_spec import (DTensorSpec,
                                                            TensorMeta)
        mesh = next(t.device_mesh for t in _leaves((args, kwargs))
                    if isinstance(t, DTensor))
        every = tuple(range(mesh.ndim))
        args, kwargs = tree_map(
            lambda t: self._gather(t, every)._local_tensor
            if isinstance(t, DTensor) else t, (args, kwargs))
        with self:
            out = func(*args, **kwargs)

        def wrap(o):
            if not isinstance(o, torch.Tensor):
                return o
            spec = DTensorSpec(mesh, (Replicate(),) * mesh.ndim,
                               tensor_meta=TensorMeta(o.shape, o.stride(),
                                                      o.dtype))
            return DTensor(o, spec, requires_grad=False)
        return tree_map(wrap, out)

    def _reduced(self, t):
        if not isinstance(t, DTensor) or not any(
                "MaskPartial" in type(p).__name__ for p in t.placements):
            return t
        pl = [Replicate() if "MaskPartial" in type(p).__name__ else p
              for p in t.placements]
        return _redistribute(t, pl)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            if self._handing_over:         # the call re-issued below
                self._handing_over = False
                return NotImplemented
            return self._dtensor_op(func, args, kwargs)
        out = func(*args, **kwargs)
        ins = [t for t in _leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        outs = [t for t in _leaves(out) if isinstance(t, torch.Tensor)]
        if not all(t.device.type == "meta" for t in ins + outs):
            return out
        self.ops += 1
        packet = func._overloadpacket
        name = packet.__name__
        if func.namespace == "_c10d_functional":
            if name not in _NOT_COLL:
                self.collective(_COLL_KIND.get(name, name),
                                sum(t.nbytes for t in outs))
            return out
        if packet in flop_registry:
            self.products += int(flop_registry[packet](*args, **kwargs,
                                                       out_val=out))
        elif torch.Tag.pointwise in func.tags:
            self.elementwise += sum(t.numel() for t in outs)
        elif name in _REDUCTIONS and ins:
            self.elementwise += ins[0].numel()
        if not func.is_view and name not in _NO_BYTES:
            self.bytes += sum(t.nbytes for t in ins + outs)
        return out

    @property
    def flops(self) -> int:
        return self.products + self.elementwise

    def collectives(self) -> dict:
        """``{kind: bytes, ..., "total": bytes, "count": n}``."""
        d = dict(self.coll)
        d["total"] = sum(self.coll.values())
        d["count"] = self.coll_count
        return d



def _redistribute(t, placements) -> DTensor:
    """``t`` redistributed to ``placements`` below autograd: the local
    collectives of ``DTensor.redistribute`` without its autograd Function,
    whose bookkeeping some torch versions dispatch as DTensor ops that
    have no sharding rule (``aten.detach_`` in torch 2.11) when it runs
    inside a dispatch mode."""
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor._redistribute import (
        redistribute_local_tensor)
    spec = DTensorSpec(t.device_mesh, tuple(placements),
                       tensor_meta=t._spec.tensor_meta)
    if spec.placements == t._spec.placements:
        return t
    local = redistribute_local_tensor(t._local_tensor, t._spec, spec)
    return DTensor(local, spec, requires_grad=False)


def count_step(step, args, *, weights=(), fsdp_dims=(),
               out_placements=None) -> tuple:
    """Run ``step(*args)`` once under :class:`CostCounter` (``weights``
    and ``fsdp_dims`` its ZeRO-3 rule), with plain tensors made inside the
    step taken as replicated beside the DTensors
    (``implicit_replication``: positions, masks, the zero aux, the fold's
    coefficients), and its outputs redistributed to ``out_placements``
    (counted). Returns (counter, output, seconds)."""
    from torch.distributed.tensor import placement_types
    from torch.distributed.tensor.experimental import implicit_replication
    counter = CostCounter(weights, fsdp_dims)
    t0 = time.perf_counter()
    with implicit_replication(), counter, mock.patch.object(
            placement_types, "shard_dim_alltoall", counter.all_to_all):
        out = step(*args)
        if out_placements is not None:
            out = _redistributed(out, out_placements)
    return counter, out, time.perf_counter() - t0


def _redistributed(out, pl):
    """Each DTensor of ``out`` redistributed to its placements in ``pl`` (a
    congruent tree), as the reference's ``out_shardings`` force."""
    if isinstance(out, DTensor):
        return out if pl is None else _redistribute(out, pl)
    if isinstance(out, dict):
        return {k: _redistributed(v, pl[k]) for k, v in out.items()}
    if isinstance(out, tuple) and not _is_placements(pl):
        return type(out)(*(_redistributed(v, q) for v, q in zip(out, pl))) \
            if hasattr(out, "_fields") else tuple(
                _redistributed(v, q) for v, q in zip(out, pl))
    return out


def _is_placements(pl) -> bool:
    from torch.distributed.tensor.placement_types import Placement
    return isinstance(pl, tuple) and bool(pl) and all(
        isinstance(p, Placement) for p in pl)


def _fsdp_dims(mesh, fsdp) -> tuple:
    axes = () if fsdp is None else (
        tuple(fsdp) if isinstance(fsdp, tuple) else (fsdp,))
    return tuple(mesh.mesh_dim_names.index(a) for a in axes)


def roofline(flops: float, bytes_acc: float, coll: float) -> dict:
    """Seconds each term takes at the H100's rates, and the dominant one."""
    r = {"compute_s": flops / PEAK_FLOPS, "memory_s": bytes_acc / HBM_BW,
         "collective_s": coll / ICI_BW}
    r["dominant"] = max(("compute_s", "memory_s", "collective_s"),
                        key=lambda k: r[k])
    return r


def run_combo(arch: str, shape_name: str, *, multi_pod: bool = False,
              mode: str = "temporal", attn_window: int = 0,
              fsdp: str | None = "data", remat: bool = True,
              unroll: bool = False, verbose: bool = True, mesh=None,
              cfg=None, shape=None, detail: bool = False,
              frontend_dtype=torch.bfloat16) -> dict:
    """Run one (arch x shape x mesh) combination's step on meta DTensors
    and count it. ``mesh`` (default: the production mesh, opening its fake
    world), ``cfg`` and ``shape`` (default: the registry's) may be given to
    count another mesh, a reduced config or another batch. The record has
    the reference's keys; ``detail`` adds one more, ``detail``: FLOPs by
    kind (products, elementwise), the ops counted, the DTensor ops whose
    redistributions moved the most bytes, and the ops regathered."""
    cfg = cfg or get_config(arch)
    if attn_window:
        cfg = windowed_variant(cfg, attn_window)
    shape = shape or get_shape(shape_name)
    if mesh is None:
        open_world(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh_chips(mesh)
    mesh_name = "x".join(map(str, mesh.mesh.shape))
    t0 = time.perf_counter()
    step, args, in_pl, out_pl, meta = build_dryrun(
        cfg, shape, mesh, mode=mode, fsdp=fsdp, remat=remat, unroll=unroll,
        frontend_dtype=frontend_dtype)
    t_build = time.perf_counter() - t0
    counter, out, t_run = count_step(
        step, args, weights=_leaves(args[0]), fsdp_dims=_fsdp_dims(mesh, fsdp),
        out_placements=out_pl)
    flops, bytes_acc, coll = counter.flops, counter.bytes, counter.collectives()
    record = {
        "arch": cfg.name, "shape": shape.name, "mesh": mesh_name,
        "chips": chips, "mode": mode, **meta, "unroll": unroll,
        # the reference's lower/compile seconds: building the meta DTensors
        # and running the step on them
        "lower_s": round(t_build, 1), "compile_s": round(t_run, 1),
        "flops_per_device": flops, "bytes_per_device": bytes_acc,
        "collective_bytes_per_device": coll,
        "client_probe": None,
        "memory": {"argument_size_in_bytes": local_bytes(args),
                   "output_size_in_bytes": local_bytes(out),
                   "temp_size_in_bytes": None,
                   "generated_code_size_in_bytes": None},
        "roofline": roofline(flops, bytes_acc, coll["total"]),
    }
    if detail:
        record["detail"] = {
            "flops_by_kind": {"products": counter.products,
                              "elementwise": counter.elementwise},
            "ops_counted": counter.ops,
            # the DTensor ops whose redistributions moved the most bytes
            "collective_bytes_by_op": dict(sorted(
                counter.coll_by_op.items(), key=lambda kv: -kv[1])[:8]),
            "regathered_ops": dict(counter.regathered)}
    if verbose:
        r = record["roofline"]
        print(f"[dryrun] {cfg.name} x {shape.name} x {mesh_name} "
              f"({meta['step']}, mode={mode}): traced {t_run:.1f}s  "
              f"flops/dev {flops:.4g}  bytes/dev {bytes_acc:.4g}  "
              f"coll/dev {coll['total']:.4g}  dominant={r['dominant']}",
              flush=True)
    return record


def iter_combos(include_swa: bool = False):
    for arch, cfg in ARCHS.items():
        for shape_name, shape in INPUT_SHAPES.items():
            if (shape.kind == "decode" and shape.seq_len > 262_144
                    and not cfg.sub_quadratic):
                if include_swa:
                    yield arch, shape_name, {"attn_window": 4096}
                continue
            yield arch, shape_name, {}


def _record_name(rec: dict) -> str:
    return (f"{rec['arch']}__{rec['shape']}__"
            f"{rec['mesh'].replace('x', '_')}.json")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mode", default="temporal",
                    choices=["temporal", "spatial"])
    ap.add_argument("--attn-window", type=int, default=0)
    ap.add_argument("--fsdp", default="data")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--unroll", action="store_true",
                    help="accepted and recorded; the port's blocks are a "
                         "Python loop, so every count is already unrolled")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) for this mesh")
    ap.add_argument("--out", default=None, help="JSON output path or dir")
    ap.add_argument("--mesh", default=None,
                    help="another fake mesh than the production one, e.g. "
                         "2x2 (axes data, model) or 2x2x2 (pod, data, "
                         "model): a check of the counts on the CPU")
    ap.add_argument("--reduced", action="store_true",
                    help="each arch at its reduced() size")
    ap.add_argument("--seq", type=int, default=None,
                    help="override the shape's sequence length")
    ap.add_argument("--batch", type=int, default=None,
                    help="override the shape's global batch")
    args = ap.parse_args(argv)

    fsdp = None if args.fsdp in ("none", "") else args.fsdp
    mesh_name = "2x16x16" if args.multi_pod else "16x16"
    kw_all = {}
    if args.mesh:
        dims = tuple(int(d) for d in args.mesh.split("x"))
        kw_all["mesh"] = make_mesh(dims, ("pod", "data", "model")[-len(dims):])
        mesh_name = args.mesh

    def setting(arch, shape_name, attn_window=0):
        kw = dict(kw_all)
        if args.reduced:
            kw["cfg"] = get_config(arch).reduced()
        if args.seq or args.batch:
            shape = get_shape(shape_name)
            kw["shape"] = dataclasses.replace(
                shape, seq_len=args.seq or shape.seq_len,
                global_batch=args.batch or shape.global_batch)
        if attn_window:
            kw["attn_window"] = attn_window
        return kw

    records = []
    if args.all:
        for arch, shape_name, kw in iter_combos():
            try:
                rec = run_combo(arch, shape_name, multi_pod=args.multi_pod,
                                mode=args.mode, fsdp=fsdp,
                                remat=not args.no_remat,
                                unroll=args.unroll,
                                **setting(arch, shape_name, **kw))
            except Exception as e:
                rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                       "error": f"{type(e).__name__}: {e}"}
                print(f"[dryrun] FAIL {arch} x {shape_name}: {e}",
                      file=sys.stderr)
            records.append(rec)
    else:
        assert args.arch and args.shape, "--arch and --shape (or --all)"
        records.append(run_combo(
            args.arch, args.shape, multi_pod=args.multi_pod, mode=args.mode,
            fsdp=fsdp, remat=not args.no_remat, unroll=args.unroll,
            **setting(args.arch, args.shape, args.attn_window)))

    if args.out:
        out = args.out
        if os.path.isdir(out) or not out.endswith(".json"):
            os.makedirs(out, exist_ok=True)
            for rec in records:
                with open(os.path.join(out, _record_name(rec)), "w") as f:
                    json.dump(rec, f, indent=1)
        else:
            with open(out, "w") as f:
                json.dump(records, f, indent=1)
    n_fail = sum(1 for r in records if "error" in r)
    print(f"[dryrun] {len(records) - n_fail}/{len(records)} combos OK")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
