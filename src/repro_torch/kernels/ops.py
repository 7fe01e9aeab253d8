"""Pytree wrappers bridging model-layout params to the Eq. 5 fold kernels
(port of ``repro.kernels.ops.adel_aggregate_pallas``).

Every leaf is folded in the canonical ``(U, L_leaf, F)`` layout of
``repro.core.compression``: a leaf whose layer id is a stacked ``(L,)``
vector keeps its leading layer axis and flattens the rest to F; a
whole-tensor leaf (a scalar layer id, as every paper-model leaf has) is
``L_leaf = 1``. So the hand-written kernel carries every leaf of the main
path, where the reference folds scalar-id leaves with a ``tensordot``; both
compute the same function.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.kernels.adel_agg import adel_agg
from repro_torch.tree import tree_map

__all__ = ["leaf_dims", "leaf_coeff_rows", "fold_leaf", "adel_aggregate"]

PyTree = Any


def _ids_ndim(ids) -> int:
    return ids.dim() if isinstance(ids, torch.Tensor) else 0


def leaf_dims(shape, ids) -> tuple[int, int]:
    """Canonical (L_leaf, F) of one param leaf of ``shape``."""
    if _ids_ndim(ids) == 0:
        return 1, math.prod(shape)
    return int(shape[0]), math.prod(shape[1:])


def leaf_coeff_rows(c: torch.Tensor, ids) -> torch.Tensor:
    """The Eq. 5 coefficient rows of one leaf: (U, L_leaf), contiguous."""
    if _ids_ndim(ids) == 0:
        return c[:, int(ids)].unsqueeze(1).contiguous()
    return c.index_select(1, ids.to(device=c.device, dtype=torch.long))


def fold_leaf(g: torch.Tensor, ids, c: torch.Tensor) -> torch.Tensor:
    """Fold one leaf of stacked client grads ``(U,) + shape`` with the
    coefficients ``c`` (U, L) through :func:`adel_agg`; returns ``shape``."""
    U = g.shape[0]
    Ll, F = leaf_dims(g.shape[1:], ids)
    out = adel_agg(g.reshape(U, Ll, F).contiguous(),
                   leaf_coeff_rows(c, ids).to(torch.float32))
    return out.reshape(g.shape[1:])


def adel_aggregate(grads: PyTree, layer_ids: PyTree, mask: torch.Tensor | None,
                   p: torch.Tensor | None, *, bias_correct: bool = True,
                   coeffs: torch.Tensor | None = None) -> PyTree:
    """Eq. 5 fold of a pytree whose leaves carry a leading client axis U.

    ``coeffs`` (U, L) overrides the coefficients computed from ``mask``
    (U, L) and ``p`` (L,) (``core.aggregation.layer_coefficients``).
    Returns the aggregated pytree (no client axis), in the grads' dtypes.
    """
    if coeffs is None:
        from repro_torch.core.aggregation import layer_coefficients
        coeffs = layer_coefficients(mask, p, bias_correct=bias_correct)
    return tree_map(lambda g, ids: fold_leaf(g, ids, coeffs), grads, layer_ids)
