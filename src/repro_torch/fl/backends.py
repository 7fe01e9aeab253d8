"""Execution backends for the round runtime, in PyTorch (port of
``repro.fl.backends``).

:class:`repro_torch.fl.runtime.RoundRuntime` plans a round (policy,
padding, clock, eval) and hands the padded round inputs to an
:class:`ExecutionBackend`, which computes and aggregates the cohort's
client updates:

* :class:`DenseBackend`        — the whole cohort in one
  ``torch.func.vmap`` and one fold.
* :class:`ChunkedBackend`      — the cohort axis ``chunk_size`` clients at
  a time; each chunk's partial aggregate is taken against the GLOBAL
  per-layer contributor counts (:func:`repro_torch.core.aggregation.
  aggregate_grads_chunk`), so the partials sum to the dense fold without a
  full ``(cohort, ...)`` delta pytree.
* :class:`ShardMapBackend`     — the cohort axis over the ranks of a
  ``torch.distributed`` process group: each rank trains its own contiguous
  rows of the cohort, folds them against the global counts, and one
  ``all_reduce`` a round sums the partials (the reference's ``shard_map``
  + ``psum``). Without a group it is one shard.
* :class:`TemporalBackend`     — one client at a time: each client's delta,
  cast to f32, is folded with its Eq. 5 coefficient row into one f32
  accumulator, so peak memory is one delta pytree whatever the cohort size.
* :class:`BufferedBackend`     — dense plus a carry ring: the layers a
  straggler finishes after the deadline are banked and folded into a later
  round with staleness weight ``lam ** tau`` (``lam=0``: dense, bit for
  bit).
* :class:`HierarchicalBackend` — two-tier edge aggregation: the cohort
  splits into edge regions (the round context's region ids, or a
  contiguous split), each region computes one partial against the global
  counts, and one global update applies their sum. A single region
  delegates to the dense backend, bit for bit.

All of them produce the same updates up to float summation order. Every
fold goes through the hand-written grouped kernels: one
``adel_agg_grouped`` launch per fold uncompressed and one
``adel_agg_q8_grouped`` launch per fold under int8 (a plain scatter-add a
leaf for topk8), so a round launches one fold (dense), one a chunk
(chunked), one a rank (shard_map), one a client (temporal), one a region
(hierarchical), or one plus one a carry slot folded that round
(buffered). Under
compression the reduction consumes the wire payload: each slice of the
cohort is compressed (:func:`repro_torch.core.compression.
compress_deltas`) and folded into an f32 accumulator. HeteroFL rounds
(width masks) take the width-overlap mean
(:func:`repro_torch.core.aggregation.hetero_overlap_partials`), plain
PyTorch as in the reference, through the same chunk/region/client loops,
and reject compression.

The fold's dtype contract: a fold returns the deltas' dtype (as the
kernel and the reference's Pallas path do), and every server update is
applied in f32 and cast back to the params' dtype (:func:`_sub32`), so
bf16 params stay bf16. The temporal backend accumulates in f32, as the
reference's does.

Telemetry: every backend carries the runtime's tracer (``set_tracer``,
default :data:`repro_torch.obs.NULL_TRACER`). Each emits ``local_train``
spans around the client updates and ``aggregate`` spans around the folds
and the update (per chunk, client or region, plus one around the final
update), and the ``aggregate_bytes_logical`` / ``aggregate_bytes_wire``
counters (analytic: :func:`repro_torch.core.compression.payload_bytes`).
An active tracer synchronizes a CUDA device at the end of each span, so
spans measure the card's work; numerics are untouched either way.

Backends are selected through :class:`repro_torch.fl.spec.ExecSpec`
(``make_backend(exec=spec, model=model)``) or by legacy name; both resolve
through :meth:`ExecSpec.resolve`.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.aggregation import (aggregate_grads,
                                          aggregate_grads_chunk,
                                          aggregate_with_coeffs,
                                          all_reduce_tree,
                                          hetero_overlap_mean,
                                          hetero_overlap_partials,
                                          layer_coefficients)
from repro_torch.core.compression import (aggregate_compressed,
                                          compress_deltas, make_compression,
                                          payload_bytes)
from repro_torch.core.straggler import late_arrival_delays, late_p_layers
from repro_torch.device import resolve_device, sync
from repro_torch.fl.client import batched_client_deltas
from repro_torch.fl.spec import AGG_IMPLS, BACKENDS, ExecSpec
from repro_torch.launch.mesh import (MESH_AXES, batch_shards,
                                     make_client_group, shard_index)
from repro_torch.obs import NULL_TRACER
from repro_torch.tree import tree_map

__all__ = ["BACKENDS", "AGG_IMPLS", "ExecSpec", "ExecutionBackend",
           "DenseBackend", "ChunkedBackend", "ShardMapBackend",
           "TemporalBackend", "BufferedBackend", "HierarchicalBackend",
           "make_backend"]

PyTree = Any


def _sub32(w: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """dtype-preserving server update, computed in f32."""
    return (w.to(torch.float32) - d.to(torch.float32)).to(w.dtype)


def apply_update(params: PyTree, agg: PyTree) -> PyTree:
    """The server update ``params - agg``, leaf by leaf in f32."""
    return tree_map(_sub32, params, agg)


class ExecutionBackend:
    """Executes one federated round over a padded cohort.

    ``run_round`` receives per-client batches ``xb/yb/wb`` with leading
    axis ``U_pad = cohort_pad(cohort_size)``, the (U_pad, L) contribution
    mask (padded rows all-zero, so they contribute nothing), the (L,)
    zero-contributor probabilities ``p``, the round's learning rate, and —
    for HeteroFL rounds — a width-mask pytree with leading axis U_pad. It
    returns the updated global params; params are never updated in place.
    """

    name = "base"
    #: backends that read the runtime's per-round
    #: :class:`repro_torch.fl.runtime.RoundContext` (``ctx=``)
    needs_ctx = False

    def __init__(self, model, *, local_iters: int = 1, l2: float = 0.0,
                 donate: bool = True, compression=None,
                 agg_impl: str = "jnp", device=None):
        self.model = model
        self.local_iters = int(local_iters)
        self.l2 = float(l2)
        self.donate = bool(donate)
        self.compression = make_compression(compression)
        self.agg_impl = str(agg_impl)
        assert self.agg_impl in AGG_IMPLS, \
            f"unknown agg_impl {agg_impl!r}; known: {AGG_IMPLS}"
        self.device = resolve_device(device)
        self.tracer = NULL_TRACER
        self._bytes_cache: dict[int, tuple[int, int]] = {}

    def set_tracer(self, tracer) -> None:
        """Attach the runtime's tracer (:class:`repro_torch.obs.Tracer`)."""
        self.tracer = tracer if tracer is not None else NULL_TRACER

    def _round_bytes(self, params_like: PyTree, U: int) -> tuple[int, int]:
        """Analytic (logical, wire) payload bytes of a U-client reduction
        under this backend's compression; ``params_like`` supplies leaf
        shapes only."""
        key = int(U)
        if key not in self._bytes_cache:
            ids = self.model.layer_ids(params_like)
            self._bytes_cache[key] = payload_bytes(params_like, ids, key,
                                                   self.compression)
        return self._bytes_cache[key]

    def _count_bytes(self, params_like: PyTree, U: int) -> None:
        logical, wire = self._round_bytes(params_like, U)
        self.tracer.count("aggregate_bytes_logical", logical,
                          backend=self.name)
        self.tracer.count("aggregate_bytes_wire", wire, backend=self.name)

    def _check_rule(self, wmasks) -> None:
        """HeteroFL's width-overlap mean is an entry-wise mean, not an Eq. 5
        coefficient fold: the quantized wire format has no sound
        dequant-weight for it."""
        if wmasks is not None and self.compression.mode != "none":
            raise ValueError(
                f"compression={self.compression.mode!r} is incompatible "
                f"with HeteroFL width-mask aggregation")

    def _fence(self) -> None:
        """Under an active tracer, wait for the device so the enclosing
        span measures its work."""
        if self.tracer.active:
            sync(self.device)

    def cohort_pad(self, U: int) -> int:
        """Smallest padded cohort width >= U this backend can execute."""
        return int(U)

    def reset_state(self) -> None:
        """Clear cross-round server-side state; the runtime calls this at
        the start of every run. Stateless backends are a no-op."""

    def warm_up(self, params: PyTree, xb, yb, wb, mask, p, eta, *,
                bias_correct: bool = True, wmasks: PyTree | None = None,
                ctx=None) -> float:
        """Run the real :meth:`run_round` once on a zero-filled copy of
        ``params`` with the caller's round inputs and discard the result,
        so the first measured round does not pay the one-off costs (loading
        the CUDA libraries, cuDNN's and cuBLAS's handles and algorithm
        choices, the kernels' first launch). Returns seconds spent.

        The dummy round runs with the tracer muted (this backend's and any
        backend it delegates to), draws no random number, and the backend's
        state is left as it was found: :meth:`reset_state` erases what the
        dummy round banked, then the attributes are restored (the
        hierarchical backend's ``last_regions``; the byte-counter cache,
        which a muted round does not fill). Every rank of a shard_map group
        calls it, so the collectives still pair up."""
        t0 = obs.now()
        dummy = tree_map(torch.zeros_like, params)
        tracer, found = self.tracer, dict(vars(self))
        self.set_tracer(NULL_TRACER)
        try:
            self.run_round(dummy, xb, yb, wb, mask, p, eta,
                           bias_correct=bias_correct, wmasks=wmasks, ctx=ctx)
            sync(self.device)
        finally:
            self.reset_state()
            vars(self).update(found)
            self.set_tracer(tracer)
        return obs.now() - t0

    def run_round(self, params: PyTree, xb, yb, wb, mask, p, eta, *,
                  bias_correct: bool, wmasks: PyTree | None = None,
                  ctx=None) -> PyTree:
        raise NotImplementedError

    def describe(self) -> dict:
        return {"backend": self.name, "donate": self.donate,
                "compression": self.compression.mode,
                "agg_impl": self.agg_impl}

    # shared sub-computations -------------------------------------------
    def _inputs(self, xb, yb, wb, mask, p):
        dev = self.device
        return (xb.to(dev), yb.to(dev), wb.to(dev),
                mask.to(device=dev, dtype=torch.float32),
                p.to(device=dev, dtype=torch.float32))

    def _deltas(self, params, xb, yb, wb, eta):
        return batched_client_deltas(self.model.loss, params, xb, yb, wb,
                                     eta, local_iters=self.local_iters,
                                     l2=self.l2)

    def _partial(self, params, deltas, mask, p, counts, *, bias_correct,
                 wmasks):
        """The aggregate of one slice of the cohort: its (num, den)
        width-overlap partials for HeteroFL, else its Eq. 5 fold against
        ``counts`` (the global per-layer contributor counts; None when the
        slice is the whole cohort) — from the wire payload under
        compression (f32), else from the deltas (their dtype)."""
        if wmasks is not None:
            return hetero_overlap_partials(deltas, wmasks, mask[:, 0])
        ids = self.model.layer_ids(params)
        comp = self.compression
        if comp.mode != "none":
            # the reduction consumes the wire payload: the float32 delta
            # tree never feeds the aggregation
            payload = compress_deltas(deltas, ids, comp)
            return aggregate_compressed(payload, params, ids, mask, p,
                                        cfg=comp, counts=counts,
                                        bias_correct=bias_correct)
        if counts is None:
            return aggregate_grads(deltas, ids, mask, p,
                                   bias_correct=bias_correct)
        return aggregate_grads_chunk(deltas, ids, mask, p, counts,
                                     bias_correct=bias_correct)

    @staticmethod
    def _finish(params, agg, hetero: bool):
        if hetero:
            agg = hetero_overlap_mean(*agg)
        return apply_update(params, agg)

    def _combine(self, acc: PyTree) -> PyTree:
        """The sum of the slices' partials across the processes that share
        the round: nothing to add in one process (shard_map sums over its
        group)."""
        return acc

    def _run_slices(self, params, xb, yb, wb, mask, p, eta, slices, *,
                    bias_correct, wmasks, label, dtype=None, first=0):
        """One round as a loop over slices of the cohort: ``slices`` holds
        ``(index, clients)`` pairs (a slice or an index tensor into the
        cohort axis, and the clients it counts in the byte counters). Each
        slice's deltas (cast to ``dtype`` if given) give one partial
        against the global counts; the partials are summed, combined across
        processes (:meth:`_combine`) and applied in one update. ``first``
        numbers the slices in the spans."""
        tracer = self.tracer
        hetero = wmasks is not None
        counts = mask.sum(0)                  # (L,) GLOBAL contributors
        acc = None
        for j, (sl, n) in enumerate(slices, first):
            with tracer.span("local_train", backend=self.name, **{label: j}):
                deltas = self._deltas(params, xb[sl], yb[sl], wb[sl], eta)
                if dtype is not None:
                    deltas = tree_map(lambda d: d.to(dtype), deltas)
                self._fence()
            if tracer.active:
                self._count_bytes(params, n)
            with tracer.span("aggregate", backend=self.name, **{label: j}):
                wm = (None if not hetero
                      else tree_map(lambda m: m[sl], wmasks))
                part = self._partial(params, deltas, mask[sl], p, counts,
                                     bias_correct=bias_correct, wmasks=wm)
                acc = part if acc is None else tree_map(torch.add, acc, part)
                self._fence()
            # the next slice's local update must not find this slice's
            # deltas and partial still held (two param-sized pytrees)
            del deltas, part
        with tracer.span("aggregate", backend=self.name,
                         **{label + "s": len(slices)}):
            out = self._finish(params, self._combine(acc), hetero)
            self._fence()
        return out


class DenseBackend(ExecutionBackend):
    """Whole cohort in one vmap + one grouped fold a round."""

    name = "dense"

    def run_round(self, params, xb, yb, wb, mask, p, eta, *,
                  bias_correct, wmasks=None, ctx=None):
        self._check_rule(wmasks)
        xb, yb, wb, mask, p = self._inputs(xb, yb, wb, mask, p)
        tracer = self.tracer
        with tracer.span("local_train", backend=self.name):
            deltas = self._deltas(params, xb, yb, wb, eta)
            self._fence()
        if tracer.active:
            self._count_bytes(params, mask.shape[0])
        with tracer.span("aggregate", backend=self.name):
            agg = self._partial(params, deltas, mask, p, None,
                                bias_correct=bias_correct, wmasks=wmasks)
            out = self._finish(params, agg, wmasks is not None)
            self._fence()
        return out


class ChunkedBackend(ExecutionBackend):
    """Sequential chunk sums over the client axis.

    The cohort is padded to a ``chunk_size`` multiple; each chunk's partial
    aggregate uses the GLOBAL per-layer contributor counts, so summing the
    partials over chunks equals the dense fold on the concatenated client
    axis (one grouped fold launch a chunk). Under compression each chunk's
    int8 payload is folded into an f32 accumulator. A single-chunk cohort
    falls through to the dense backend.
    """

    name = "chunked"

    def __init__(self, model, *, chunk_size: int = 16, **kw):
        super().__init__(model, **kw)
        self.chunk_size = max(int(chunk_size), 1)
        self._dense = DenseBackend(model, **kw)

    def cohort_pad(self, U: int) -> int:
        c = min(self.chunk_size, int(U))   # never vmap dead padding
        return -(-int(U) // c) * c

    def set_tracer(self, tracer) -> None:
        super().set_tracer(tracer)
        self._dense.set_tracer(tracer)     # single-chunk fall-through

    def run_round(self, params, xb, yb, wb, mask, p, eta, *,
                  bias_correct, wmasks=None, ctx=None):
        self._check_rule(wmasks)
        U = int(mask.shape[0])
        c = min(self.chunk_size, U)
        if U <= c:
            return self._dense.run_round(params, xb, yb, wb, mask, p, eta,
                                         bias_correct=bias_correct,
                                         wmasks=wmasks)
        xb, yb, wb, mask, p = self._inputs(xb, yb, wb, mask, p)
        slices = [(slice(c0, c0 + c), c) for c0 in range(0, U, c)]
        return self._run_slices(params, xb, yb, wb, mask, p, eta, slices,
                                bias_correct=bias_correct, wmasks=wmasks,
                                label="chunk")

    def describe(self):
        return {**super().describe(), "chunk_size": self.chunk_size}


class ShardMapBackend(ExecutionBackend):
    """The cohort axis as the ranks of a ``torch.distributed`` process
    group: the port of the reference's ``shard_map`` + ``lax.psum``.

    The cohort is padded to a multiple of the group's size; rank r trains
    only its own contiguous rows ``[r U_pad/n, (r+1) U_pad/n)``. Every rank
    plans and stacks the whole cohort from the same seed, so the ranks
    agree on the mask, ``p`` and the batches without a broadcast, and the
    global per-layer counts are the whole mask's. Each rank takes one
    partial against them (one grouped fold launch a rank: uncompressed,
    int8 from its clients' payload, or HeteroFL's (num, den)); the partials
    are flattened into one buffer of their dtype and summed by one
    ``all_reduce`` a round (:func:`repro_torch.core.aggregation.
    all_reduce_tree`; f32 under int8, the grads' dtype otherwise); every
    rank applies the same update in f32 and holds the same params.

    ``mesh`` is the process group (None: the default group if one is
    initialized). With none there is one shard holding the whole cohort,
    the reference's one-device mesh, bit for bit the dense backend.
    """

    name = "shard_map"

    def __init__(self, model, *, mesh=None, **kw):
        super().__init__(model, **kw)
        self.group = make_client_group() if mesh is None else mesh

    @property
    def n_shards(self) -> int:
        return batch_shards(self.group)

    def cohort_pad(self, U: int) -> int:
        n = self.n_shards
        return -(-int(U) // n) * n

    def _combine(self, acc):
        return all_reduce_tree(acc, self.group)

    def run_round(self, params, xb, yb, wb, mask, p, eta, *,
                  bias_correct, wmasks=None, ctx=None):
        self._check_rule(wmasks)
        xb, yb, wb, mask, p = self._inputs(xb, yb, wb, mask, p)
        U, n, r = int(mask.shape[0]), self.n_shards, shard_index(self.group)
        if U % n:
            raise ValueError(f"cohort of {U} does not split over {n} shards "
                             f"(pad it to cohort_pad({U}))")
        per = U // n
        return self._run_slices(params, xb, yb, wb, mask, p, eta,
                                [(slice(r * per, (r + 1) * per), per)],
                                bias_correct=bias_correct, wmasks=wmasks,
                                label="shard", first=r)

    def describe(self):
        return {**super().describe(), "shards": self.n_shards,
                "mesh_axes": list(MESH_AXES)}


class TemporalBackend(ExecutionBackend):
    """Clients as grad-accumulation microbatches, one at a time.

    Each client's local update runs alone; its delta, cast to f32, is
    folded with its Eq. 5 coefficient row (the global counts') in one
    grouped launch — or, under int8, compressed and folded through
    :func:`repro_torch.core.compression.aggregate_compressed` — into a
    single f32 accumulator, so peak memory is one delta pytree regardless
    of cohort size (the layout the reference keeps for its largest
    architectures). HeteroFL rounds accumulate the width-overlap (num, den)
    partials instead.
    """

    name = "temporal"

    def run_round(self, params, xb, yb, wb, mask, p, eta, *,
                  bias_correct, wmasks=None, ctx=None):
        self._check_rule(wmasks)
        xb, yb, wb, mask, p = self._inputs(xb, yb, wb, mask, p)
        slices = [(slice(u, u + 1), 1) for u in range(int(mask.shape[0]))]
        return self._run_slices(params, xb, yb, wb, mask, p, eta, slices,
                                bias_correct=bias_correct, wmasks=wmasks,
                                label="client", dtype=torch.float32)


class BufferedBackend(DenseBackend):
    """Semi-async delayed-gradient execution: the layers a straggler misses
    at the deadline are banked and folded into later rounds with staleness
    decay.

    The round-synchronous Eq. 5 fold discards every layer a client did not
    finish by the deadline. This backend keeps that work: the straggler
    continues its backward pass, and the layers it finishes LATE — the
    complement ``1 - mask`` of the round's contribution mask — arrive once
    the simulated clock reaches

        ``arrival_u = round_end + max(L - z_u, 0) * S_u / P_u + B_u``

    (:func:`repro_torch.core.straggler.late_arrival_delays`). Each later
    round ``t`` folds every banked contribution whose arrival the clock has
    passed, with weight ``lam ** tau`` (``tau = t - work_round >= 1``),
    through the Eq. 5 coefficient path: the banked coefficients are
    :func:`repro_torch.core.aggregation.layer_coefficients` of the LATE
    mask with the late-set zero-contributor probabilities
    (:func:`repro_torch.core.straggler.late_p_layers`), so at weight 1 the
    fold is an unbiased estimate of the late set's layer mean.

    A round runs in five steps, as the reference's:

    1. fold decisions on the host, over the ring's slot metadata, in the
       reference's float32 numpy arithmetic (an eligibility that flipped
       at a boundary would change the trajectory);
    2. the round's late-set coefficients, on the host;
    3. the local updates and the on-time fold (one grouped launch),
       keeping the round's bankable payload: the f32 deltas, or under
       compression the SAME wire tuples the on-time fold consumed;
    4. one fold of each eligible slot with coefficients ``c_late * w``
       (one ``adel_agg_grouped`` launch, or ``adel_agg_q8_grouped`` for
       int8 tuples), each applied to params in f32;
    5. banking, into a ring of ``buffer_cap`` slots (the oldest evicted).

    The decisions read the planner's host copy of the mask
    (``ctx.mask``), never the device's copy, so a buffered round adds no
    device sync. A slot owns its payload: the deltas and wire tuples are
    fresh outputs of the round's local update and compression, referenced
    by nothing the runtime reuses (not the stacked batch buffers, not the
    prefetch double buffer, not a fold's output), allocated on the main
    stream, and never written in place; the caching allocator cannot hand
    their memory on while the slot holds them. A round never mutates a
    slot in place either (it rebuilds the ring), so :meth:`warm_up`'s
    restore of the ring is exact. Work older than ``max_age`` rounds, or
    evicted by the ring, is dropped (the ``carried_dropped`` ledger
    column).

    ``lam=0`` (the default) delegates every round to the inherited dense
    round, bit for bit. ``lam>0`` needs the runtime's
    :class:`repro_torch.fl.runtime.RoundContext` (``ctx=``) and rejects
    HeteroFL width-mask rounds (the width-overlap mean has no late-set
    analogue). ``last_carry`` holds the round's ``carried_in`` /
    ``carried_out`` / ``carried_dropped`` counts and the ``stale``
    histogram for the runtime's ledger.
    """

    name = "buffered"

    def __init__(self, model, *, lam: float = 0.0, max_age: int = 4,
                 buffer_cap: int = 4, **kw):
        super().__init__(model, **kw)
        if not 0.0 <= float(lam) <= 1.0:
            raise ValueError(f"lam={lam} must be in [0, 1]")
        self.lam = float(lam)
        self.max_age = int(max_age)
        self.buffer_cap = int(buffer_cap)
        self._slots: list[dict] = []     # FIFO ring of banked rounds
        self.last_carry: dict = {}

    @property
    def needs_ctx(self) -> bool:        # type: ignore[override]
        return self.lam > 0.0

    def reset_state(self) -> None:
        self._slots = []
        self.last_carry = {}

    def describe(self):
        return {**super().describe(), "lam": self.lam,
                "max_age": self.max_age, "buffer_cap": self.buffer_cap}

    @staticmethod
    def late_coefficients(mask: np.ndarray, U_act: int, lam, *,
                          bias_correct: bool = True) -> torch.Tensor:
        """The round's late-set Eq. 5 coefficients, on the host: the
        complement ``1 - mask`` of the (U_pad, L) host mask over the first
        ``U_act`` (real) rows, with the late-set zero-contributor
        probabilities of the rates ``lam`` (U_act,)."""
        real = np.arange(mask.shape[0]) < U_act
        late = torch.from_numpy(((1.0 - mask) * real[:, None]).astype(
            np.float32))
        p_late = late_p_layers(torch.as_tensor(lam, dtype=torch.float32),
                               mask.shape[1])
        return layer_coefficients(late, p_late, bias_correct=bias_correct)

    def _fold_slot(self, params, slot: dict, w: np.ndarray):
        """``params - sum_u (c_late[u] * w[u]) . delta_u`` for one slot:
        one grouped fold of its banked payload."""
        ids = self.model.layer_ids(params)
        coeffs = (slot["c_late"] * torch.from_numpy(w)[:, None]).to(
            self.device)
        if self.compression.mode != "none":
            agg = aggregate_compressed(slot["banked"], params, ids, None,
                                       None, cfg=self.compression,
                                       coeffs=coeffs)
        else:
            agg = aggregate_with_coeffs(slot["banked"], ids, coeffs)
        return apply_update(params, agg)

    def run_round(self, params, xb, yb, wb, mask, p, eta, *,
                  bias_correct, wmasks=None, ctx=None):
        if self.lam == 0.0:
            # exact round-synchronous semantics: the dense round, bit for
            # bit, with no carry
            return super().run_round(params, xb, yb, wb, mask, p, eta,
                                     bias_correct=bias_correct,
                                     wmasks=wmasks)
        if wmasks is not None:
            raise ValueError("buffered backend with lam>0 is incompatible "
                             "with HeteroFL width-mask aggregation")
        if ctx is None:
            raise ValueError("buffered backend with lam>0 needs the "
                             "runtime's RoundContext (ctx=): the carry "
                             "buffer is driven by the simulated clock")
        if ctx.mask is None:
            raise ValueError("buffered backend needs the planner's host "
                             "copy of the mask (ctx.mask)")
        self._check_rule(wmasks)
        mask_h = np.asarray(ctx.mask, np.float32)
        U_pad, L = mask_h.shape
        U_act = int(ctx.U_act)
        t = int(ctx.t)
        depth = mask_h.sum(1)                         # (U_pad,) realized z
        real = np.arange(U_pad) < U_act
        late_rows = real & (depth < L)

        # 1. fold decisions on the host, over copies of the slots' pending
        #    rows: which banked arrivals has the simulated clock passed?
        slots = [dict(s, pending=s["pending"].copy()) for s in self._slots]
        folds, dropped, stale = [], 0, {}
        for slot in slots:
            pend = slot["pending"]
            if not pend.any():
                continue
            tau = t - slot["round"]
            if tau > self.max_age:
                dropped += int(pend.sum())
                pend[:] = False
                continue
            elig = pend & (slot["arrival"] <= float(ctx.sim_end))
            if elig.any():
                w = np.where(elig, np.float32(self.lam) ** tau,
                             np.float32(0.0)).astype(np.float32)
                folds.append((slot, w))
                stale[tau] = stale.get(tau, 0) + int(elig.sum())
                pend &= ~elig

        # 2. this round's late-set coefficients: Eq. 5 on the COMPLEMENT
        #    mask with the late-set zero-contributor probabilities
        bank = bool(late_rows.any())
        if bank:
            c_late = self.late_coefficients(mask_h, U_act, ctx.lam,
                                            bias_correct=bool(bias_correct))

        # 3. the local updates and the on-time fold, keeping the bankable
        #    payload
        xb, yb, wb, mask, p = self._inputs(xb, yb, wb, mask, p)
        tracer, comp = self.tracer, self.compression
        with tracer.span("local_train", backend=self.name):
            deltas = self._deltas(params, xb, yb, wb, eta)
            self._fence()
        if tracer.active:
            self._count_bytes(params, U_pad)
        with tracer.span("aggregate", backend=self.name):
            ids = self.model.layer_ids(params)
            if comp.mode != "none":
                banked = compress_deltas(deltas, ids, comp)
                agg = aggregate_compressed(banked, params, ids, mask, p,
                                           cfg=comp,
                                           bias_correct=bias_correct)
            else:
                banked = tree_map(lambda d: d.to(torch.float32), deltas)
                agg = aggregate_grads(deltas, ids, mask, p,
                                      bias_correct=bias_correct)
            params = apply_update(params, agg)
            self._fence()

        # 4. fold every arrived carry slot
        if folds:
            with tracer.span("aggregate", backend=self.name,
                             carried=sum(int((w > 0).sum())
                                         for _, w in folds)):
                for slot, w in folds:
                    params = self._fold_slot(params, slot, w)
                self._fence()

        # 5. bank this round's late work (ring eviction drops the oldest)
        if bank:
            delays = late_arrival_delays(depth[:U_act], ctx.layer_s, ctx.B,
                                         L)
            arrival = np.full(U_pad, np.inf, np.float32)
            arrival[:U_act] = float(ctx.sim_end) + np.asarray(delays)
            if len(slots) >= self.buffer_cap:
                evicted = slots.pop(0)
                dropped += int(evicted["pending"].sum())
            slots.append({"round": t, "banked": banked, "c_late": c_late,
                          "arrival": arrival, "pending": late_rows.copy()})
        self._slots = slots

        carried_in = sum(stale.values())
        carried_out = sum(int(s["pending"].sum()) for s in slots)
        self.last_carry = {"carried_in": carried_in,
                           "carried_out": carried_out,
                           "carried_dropped": dropped,
                           "stale": stale}
        tracer.count("carried_in", carried_in, backend=self.name)
        tracer.count("carried_out", carried_out, backend=self.name)
        if dropped:
            tracer.count("carried_dropped", dropped, backend=self.name)
        return params


class HierarchicalBackend(ChunkedBackend):
    """Two-tier edge aggregation: per-region partials + one global update.

    1. The padded cohort is partitioned into edge regions. Region ids come
       from the round context (``ctx.regions``); without them the cohort
       splits into ``regions`` contiguous slices, so the backend works
       under plain ``run_federated`` too.
    2. Each region runs its clients' local updates and computes ONE partial
       aggregate against the GLOBAL per-layer contributor counts (one
       grouped fold launch a region; under int8, from the region's wire
       payload into an f32 accumulator), so the partials sum to the flat
       Eq. 5 fold on the whole cohort.
    3. The server applies the summed partials in one update.

    The reference gathers each region at a width padded to a multiple of 8
    so its jit retraces once per width; the port has no trace to keep, so a
    region runs at its own width (``region_pad`` = ``region_max``).

    A single-region round (``regions=1``, or every client in one region)
    delegates to the dense backend, bit-identical to ``backend="dense"``.
    ``last_regions`` exposes the round's region census to the runtime's
    ledger (``regions`` / ``region_max`` / ``region_pad`` columns).
    """

    name = "hierarchical"
    needs_ctx = True

    def __init__(self, model, *, regions: int = 4, chunk_size: int = 16,
                 **kw):
        super().__init__(model, chunk_size=chunk_size, **kw)
        self.regions = max(int(regions), 1)
        self.last_regions: dict = {}

    def cohort_pad(self, U: int) -> int:
        return int(U)

    def reset_state(self) -> None:
        self.last_regions = {}

    def describe(self):
        return {**super().describe(), "regions": self.regions}

    def _region_groups(self, ctx, U: int) -> list[np.ndarray]:
        """Per-region member indices into the cohort axis. Pad rows keep
        the region of the fallback split (or id 0); their mask rows are
        zero, so they contribute nothing wherever they land."""
        ra = getattr(ctx, "regions", None) if ctx is not None else None
        if ra is not None:
            ra = np.asarray(ra, np.int64)
            rid = np.zeros(U, np.int64)
            rid[:min(len(ra), U)] = ra[:U]
        else:
            rid = (np.arange(U) * self.regions) // max(U, 1)
        return [np.flatnonzero(rid == g) for g in np.unique(rid)]

    def run_round(self, params, xb, yb, wb, mask, p, eta, *,
                  bias_correct, wmasks=None, ctx=None):
        self._check_rule(wmasks)
        U = int(mask.shape[0])
        groups = self._region_groups(ctx, U)
        if len(groups) <= 1:
            self.last_regions = {"regions": 1, "region_max": U,
                                 "region_pad": U}
            return self._dense.run_round(params, xb, yb, wb, mask, p, eta,
                                         bias_correct=bias_correct,
                                         wmasks=wmasks)
        rmax = max(len(g) for g in groups)
        self.last_regions = {"regions": len(groups), "region_max": rmax,
                             "region_pad": rmax}
        xb, yb, wb, mask, p = self._inputs(xb, yb, wb, mask, p)
        slices = [(torch.as_tensor(g, device=self.device), len(g))
                  for g in groups]
        return self._run_slices(params, xb, yb, wb, mask, p, eta, slices,
                                bias_correct=bias_correct, wmasks=wmasks,
                                label="region")


def make_backend(backend=None, model=None, *, exec: ExecSpec | None = None,
                 chunk_size: int | None = None, mesh=None,
                 local_iters: int | None = None, l2: float | None = None,
                 donate: bool | None = None, compression=None,
                 agg_impl: str | None = None, lam: float | None = None,
                 max_age: int | None = None, buffer_cap: int | None = None,
                 regions: int | None = None, device=None) -> ExecutionBackend:
    """Build an :class:`ExecutionBackend` on ``device`` (the card unless the
    caller passes another) from an :class:`repro_torch.fl.spec.ExecSpec`
    (``exec=``, or an ExecSpec as the first positional argument) or from
    the legacy kwargs — both funnel through :meth:`ExecSpec.resolve`, so
    the two call forms are equivalent. An :class:`ExecutionBackend`
    instance passes through unchanged.

    Legacy kwargs default to None (= the spec's value): ``backend`` names
    one of :data:`BACKENDS`; ``compression`` is a
    :mod:`repro_torch.core.compression` spec (None | mode string |
    ``(mode, top_k)`` | :class:`CompressionConfig`). Knobs the selected
    backend would ignore warn (or raise, under ``REPRO_EXEC_STRICT=1``).
    """
    if isinstance(backend, ExecutionBackend):
        return backend
    if isinstance(backend, ExecSpec):
        exec, backend = (backend if exec is None else exec), None
    legacy = dict(backend=backend, chunk_size=chunk_size, mesh=mesh,
                  local_iters=local_iters, l2=l2, donate=donate,
                  compression=compression, agg_impl=agg_impl, lam=lam,
                  max_age=max_age, buffer_cap=buffer_cap, regions=regions)
    has_legacy = any(v is not None for v in legacy.values())
    # a complete ExecSpec was validated by the resolve() that built it;
    # re-validate only when legacy kwargs modify it
    spec = ExecSpec.resolve(exec, validate=has_legacy or exec is None,
                            **legacy)
    if isinstance(spec.backend, ExecutionBackend):
        return spec.backend
    kw = dict(spec.backend_kwargs(), device=device)
    if spec.backend == "dense":
        return DenseBackend(model, **kw)
    if spec.backend == "chunked":
        return ChunkedBackend(model, chunk_size=spec.chunk_size, **kw)
    if spec.backend == "shard_map":
        return ShardMapBackend(model, mesh=spec.mesh, **kw)
    if spec.backend == "temporal":
        return TemporalBackend(model, **kw)
    if spec.backend == "buffered":
        return BufferedBackend(model, lam=spec.lam, max_age=spec.max_age,
                               buffer_cap=spec.buffer_cap, **kw)
    if spec.backend == "hierarchical":
        return HierarchicalBackend(model, regions=spec.regions,
                                   chunk_size=spec.chunk_size, **kw)
    raise ValueError(f"unknown backend {spec.backend!r}; known: {BACKENDS}")
