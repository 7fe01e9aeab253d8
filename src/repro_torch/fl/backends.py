"""Execution backends for the round runtime, in PyTorch (port of
``repro.fl.backends``).

:class:`repro_torch.fl.runtime.RoundRuntime` plans a round and hands the
round inputs to an :class:`ExecutionBackend`, which computes and
aggregates the cohort's client updates. This slice ports
:class:`DenseBackend`: the whole cohort in one ``torch.func.vmap`` and the
Eq. 5 fold of every leaf through the hand-written grouped kernels —
``core.aggregation.aggregate_grads`` (``adel_agg_grouped``) uncompressed,
``core.compression.aggregate_compressed`` (``adel_agg_q8_grouped`` for
int8, a plain scatter-add per leaf for topk8) compressed. The reference's other backends
(chunked, shard_map, temporal, buffered, hierarchical) wait for later
slices (ROADMAP.md, items 1.8-1.9).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.aggregation import aggregate_grads
from repro_torch.core.compression import (aggregate_compressed,
                                          compress_deltas, make_compression)
from repro_torch.device import resolve_device
from repro_torch.fl.client import batched_client_deltas
from repro_torch.tree import tree_map

__all__ = ["ExecutionBackend", "DenseBackend"]

PyTree = Any


def _sub32(w: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """dtype-preserving server update for float32 aggregates."""
    return (w.to(torch.float32) - d.to(torch.float32)).to(w.dtype)


class ExecutionBackend:
    """Executes one federated round over the cohort.

    ``run_round`` receives per-client batches ``xb/yb/wb`` with leading
    axis U, the (U, L) contribution mask, the (L,) zero-contributor
    probabilities ``p`` and the round's learning rate, and returns the
    updated global params. Params are not updated in place.
    """

    name = "base"

    def __init__(self, model, *, local_iters: int = 1, l2: float = 0.0,
                 compression=None, device=None):
        self.model = model
        self.local_iters = int(local_iters)
        self.l2 = float(l2)
        self.compression = make_compression(compression)
        self.device = resolve_device(device)

    def run_round(self, params: PyTree, xb, yb, wb, mask, p, eta, *,
                  bias_correct: bool) -> PyTree:
        raise NotImplementedError

    def _deltas(self, params, xb, yb, wb, eta):
        return batched_client_deltas(self.model.loss, params, xb, yb, wb,
                                     eta, local_iters=self.local_iters,
                                     l2=self.l2)


class DenseBackend(ExecutionBackend):
    """Whole cohort in one vmap + one grouped Eq. 5 fold a round."""

    name = "dense"

    def run_round(self, params, xb, yb, wb, mask, p, eta, *, bias_correct):
        dev = self.device
        xb, yb, wb = xb.to(dev), yb.to(dev), wb.to(dev)
        mask = mask.to(device=dev, dtype=torch.float32)
        p = p.to(device=dev, dtype=torch.float32)
        deltas = self._deltas(params, xb, yb, wb, eta)
        ids = self.model.layer_ids(params)
        comp = self.compression
        if comp.mode != "none":
            # the reduction consumes the wire payload: the float32 delta
            # tree never feeds the aggregation
            payload = compress_deltas(deltas, ids, comp)
            agg = aggregate_compressed(payload, params, ids, mask, p,
                                       cfg=comp, bias_correct=bias_correct)
            return tree_map(_sub32, params, agg)
        agg = aggregate_grads(deltas, ids, mask, p, bias_correct=bias_correct)
        return tree_map(lambda w, d: w - d, params, agg)
