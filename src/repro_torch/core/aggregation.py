"""Layer-wise bias-corrected aggregation (Eq. 5 of the paper), in gradient
form (port of ``repro.core.aggregation``).

For client updates w_u^l = w^l - eta * g_u^l, Eq. (5) is equivalent to

    g~^l = 0                                             if |U_t^l| = 0
         = mean_{u in U^l} g_u^l / (1 - p^l)             otherwise

followed by w~_{t+1} = w~_t - eta g~: a masked weighted reduction over the
client axis. Every fold here goes through the hand-written kernel
(:func:`repro_torch.kernels.ops.fold_tree` -> ``adel_agg_grouped``, one
launch per leaf dtype on the card) in the canonical ``(U, L_leaf, F)``
layout.

Across processes (:class:`repro_torch.fl.backends.ShardMapBackend`), each
rank folds its own slice of the cohort against the global counts and the
partials are summed with ``torch.distributed.all_reduce``
(:func:`aggregate_grads_local`, :func:`all_reduce_tree`), the port of the
reference's ``jax.lax.psum`` under ``shard_map``.

Parameter->layer mapping: ``layer_ids(params)`` is a pytree congruent with
``params`` whose leaves are an ``int`` (the whole tensor belongs to that
layer) or an ``(L,)`` integer tensor (the leading axis is a stacked-layer
axis; entry i is the layer id of slice i).
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from repro_torch.kernels.ops import adel_aggregate, fold_tree
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["layer_coefficients", "weight_by_layer", "aggregate_with_coeffs",
           "aggregate_grads", "aggregate_grads_chunk", "aggregate_grads_local",
           "all_reduce_tree",
           "hetero_overlap_partials", "hetero_overlap_mean",
           "masked_mean_grads"]

PyTree = Any


def layer_coefficients(mask: torch.Tensor, p: torch.Tensor, *,
                       bias_correct: bool = True,
                       counts: torch.Tensor | None = None) -> torch.Tensor:
    """Per-(client, layer) aggregation coefficient c[u, l]:
    c[u, l] = mask[u, l] / count_l / (1 - p_l) if count_l > 0 else 0.
    ``counts`` may be supplied externally (global counts of a chunk)."""
    if counts is None:
        counts = mask.sum(0)                                  # (L,)
    denom = torch.clamp(counts, min=1.0)
    scale = (counts > 0).to(mask.dtype)
    if bias_correct:
        scale = scale / torch.clamp(1.0 - p.to(mask.device), min=1e-6)
    return mask * (scale / denom)[None, :]                    # (U, L)


def weight_by_layer(g: torch.Tensor, ids, c_row: torch.Tensor) -> torch.Tensor:
    """Scale ONE client's leaf by its per-layer coefficient row (the fold of
    grad-accumulation layouts): sum_u weight_by_layer(g_u, ids, c[u]) equals
    :func:`aggregate_with_coeffs` with coefficients ``c``."""
    if not isinstance(ids, torch.Tensor) or ids.dim() == 0:
        return g * c_row[int(ids)]
    w = c_row.index_select(0, ids.to(device=c_row.device, dtype=torch.long))
    return g * w.reshape((-1,) + (1,) * (g.dim() - 1))


def aggregate_with_coeffs(grads: PyTree, layer_ids: PyTree,
                          coeffs: torch.Tensor) -> PyTree:
    """``agg^l = sum_u coeffs[u, l] g_u^l`` with EXPLICIT coefficients.
    grads leaves: (U,) + param.shape; coeffs: (U, L)."""
    return fold_tree(grads, layer_ids, coeffs)


def aggregate_grads(grads: PyTree, layer_ids: PyTree, mask: torch.Tensor,
                    p: torch.Tensor, *, bias_correct: bool = True) -> PyTree:
    """ADEL-FL aggregation of stacked per-client grads: mask (U, L),
    p (L,); returns the aggregated pytree (no client axis)."""
    return adel_aggregate(grads, layer_ids, mask, p, bias_correct=bias_correct)


def aggregate_grads_chunk(chunk_grads: PyTree, layer_ids: PyTree,
                          chunk_mask: torch.Tensor, p: torch.Tensor,
                          counts: torch.Tensor, *,
                          bias_correct: bool = True) -> PyTree:
    """One chunk's partial aggregate against the GLOBAL per-layer counts;
    summing the partials over all chunks equals :func:`aggregate_grads` on
    the concatenated client axis."""
    c = layer_coefficients(chunk_mask, p, bias_correct=bias_correct,
                           counts=counts)
    return aggregate_with_coeffs(chunk_grads, layer_ids, c)


def all_reduce_tree(tree: PyTree, group) -> PyTree:
    """Sum a pytree over the ranks of ``group`` (None: one shard, returned
    as it is). The leaves of each dtype are flattened into one buffer and
    summed in that dtype by one ``all_reduce``, so a tree of one dtype (a
    round's partial, or HeteroFL's (num, den)) costs one collective."""
    if group is None:
        return tree
    leaves = tree_leaves(tree)
    out: list = [None] * len(leaves)
    for dtype in dict.fromkeys(t.dtype for t in leaves):
        idx = [k for k, t in enumerate(leaves) if t.dtype == dtype]
        flat = torch.cat([leaves[k].reshape(-1) for k in idx])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        parts = flat.split([leaves[k].numel() for k in idx])
        for k, part in zip(idx, parts):
            out[k] = part.view(leaves[k].shape)
    return tree_unflatten(tree, out)


def aggregate_grads_local(local_grads: PyTree, layer_ids: PyTree,
                          local_mask: torch.Tensor, p: torch.Tensor, group,
                          *, bias_correct: bool = True) -> PyTree:
    """Explicit-collective variant: each rank of ``group`` holds a slice of
    the client axis; the per-layer counts and the weighted sums are
    combined with ``all_reduce`` (the reference's ``psum``), so every rank
    returns :func:`aggregate_grads` of the concatenated cohort. With no
    group (one shard) it is :func:`aggregate_grads_chunk` against the local
    counts.

    local_grads leaves: (U_local,) + param.shape; local_mask: (U_local, L).
    """
    counts = local_mask.sum(0)
    if group is not None:
        dist.all_reduce(counts, op=dist.ReduceOp.SUM, group=group)
    partial = aggregate_grads_chunk(local_grads, layer_ids, local_mask, p,
                                    counts, bias_correct=bias_correct)
    return all_reduce_tree(partial, group)


def hetero_overlap_partials(deltas: PyTree, wmasks: PyTree,
                            part: torch.Tensor) -> tuple[PyTree, PyTree]:
    """Per-shard partials of the HeteroFL width-overlap mean.

    HeteroFL averages each parameter ENTRY over the participating clients
    whose width-reduced submodel contains it:

        agg = sum_u part_u wm_u d_u / max(sum_u part_u wm_u, 1)

    Both sums are linear over the client axis, so a backend computes
    (num, den) partials over its slice of clients (a chunk, a region, one
    client) and adds them up before the final divide in
    :func:`hetero_overlap_mean`. Plain PyTorch, as in the reference: this
    is an entry-wise mean, not an Eq. 5 coefficient fold, and no kernel of
    the reference computes it.

    deltas/wmasks leaves: (U_local,) + param.shape; part: (U_local,)
    participation indicator (all-or-nothing rows of the layer mask).
    """
    def w(wm):
        return part.to(wm).reshape((-1,) + (1,) * (wm.dim() - 1)) * wm

    num = tree_map(lambda d, wm: (w(wm) * d).sum(0), deltas, wmasks)
    den = tree_map(lambda wm: w(wm).sum(0), wmasks)
    return num, den


def hetero_overlap_mean(num: PyTree, den: PyTree) -> PyTree:
    """Finish the width-overlap mean from combined partials; entries no
    participating client covers keep delta 0."""
    return tree_map(lambda n, d: n / torch.clamp(d, min=1.0), num, den)


def masked_mean_grads(grads: PyTree, layer_ids: PyTree,
                      mask: torch.Tensor) -> PyTree:
    """Plain masked mean without bias correction (Drop-Stragglers-style
    with an all-or-nothing mask)."""
    p = torch.zeros(mask.shape[1], dtype=mask.dtype, device=mask.device)
    return aggregate_grads(grads, layer_ids, mask, p, bias_correct=False)
