"""Wrappers bridging model layouts to the kernels (port of
``repro.kernels.ops``):

* :func:`gqa_flash` — attention in the model's (B, S, H, hd) layout through
  the flash attention kernel, read through strides (no copies);
* :func:`ssd_chunked_kernel` — the Mamba2 SSD mixer's scan in the model's
  layout through the SSD chunk-scan kernel;
* :func:`adel_aggregate` — the Eq. 5 fold of a params pytree through the
  fold kernel.

Like the kernel wrappers they call, each launches its kernel for CUDA
tensors and computes the plain version for CPU tensors. The two LM
wrappers go through the kernels' ``autograd.Function`` s
(:class:`~repro_torch.kernels.flash_attention.FlashAttention`,
:class:`~repro_torch.kernels.ssd_scan.SSDScan`), so the model trains
through them under autograd and ``torch.func`` (``vmap`` over clients: one
launch a call).

The fold:

Every leaf is folded in the canonical ``(U, L_leaf, F)`` layout of
``repro.core.compression``: a leaf whose layer id is a stacked ``(L,)``
vector keeps its leading layer axis and flattens the rest to F; a
whole-tensor leaf (a scalar layer id, as every paper-model leaf has) is
``L_leaf = 1``. So the hand-written kernel carries every leaf of the main
path, where the reference folds scalar-id leaves with a ``tensordot``; both
compute the same function. On the card the leaves of one dtype go in one
grouped launch (``adel_agg_grouped``), which reads each leaf's weights from
the (U, L) coefficients through its layer ids.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.kernels.adel_agg import adel_agg_grouped, leaf_coeff_rows
from repro_torch.kernels.flash_attention import FlashAttention
from repro_torch.kernels.ssd_scan import SSDScan
from repro_torch.tree import tree_leaves, tree_unflatten

__all__ = ["gqa_flash", "ssd_chunked_kernel", "leaf_dims", "leaf_coeff_rows",
           "fold_tree", "adel_aggregate"]

PyTree = Any


def gqa_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0) -> torch.Tensor:
    """Model layout (B, S, H, hd) / (B, S, KV, hd) -> (B, S, H, hd). The
    kernel reads the (B, H, S, hd) views through their strides and writes
    its output in q's layout, so on the card nothing is copied and the
    caller's ``reshape(B, S, H * hd)`` is a view."""
    return FlashAttention.apply(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), bool(causal),
                                int(window)).transpose(1, 2)


def ssd_chunked_kernel(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       b: torch.Tensor, c: torch.Tensor, *,
                       chunk: int = 64) -> torch.Tensor:
    """Model layout: x (B,S,H,P); dt (B,S,H); A (H,); b,c (B,S,N) -> y
    (B,S,H,P) in x's dtype (the skip term stays with the caller). Pre-scales
    ``xdt = x * dt`` and ``la = -A * dt`` in f32, in the model's layout; the
    kernel reads their (B, H, S, P) and (B, H, S) views through strides and
    writes y in xdt's (B, S, H, P) memory, so on the card nothing is copied
    between layouts. ``b`` and ``c`` go to the kernel per batch (G = B), not
    copied out per head."""
    f32 = torch.float32
    xdt = x * dt.to(f32)[..., None]        # (B, S, H, P) f32, x promoted
    la = (-A[None, None, :] * dt).to(f32)                     # (B, S, H)
    y = SSDScan.apply(xdt.transpose(1, 2), la.transpose(1, 2),
                      b.to(f32).contiguous(), c.to(f32).contiguous(), chunk)
    return y.transpose(1, 2).to(x.dtype)


def leaf_dims(shape, ids) -> tuple[int, int]:
    """Canonical (L_leaf, F) of one param leaf of ``shape``."""
    if not isinstance(ids, torch.Tensor) or ids.dim() == 0:
        return 1, math.prod(shape)
    return int(shape[0]), math.prod(shape[1:])


def fold_tree(grads: PyTree, layer_ids: PyTree, coeffs: torch.Tensor) -> PyTree:
    """``agg^l = sum_u coeffs[u, l] g_u^l`` over a pytree of stacked client
    grads ``(U,) + shape``: the leaves of each dtype in one
    :func:`adel_agg_grouped` call (one launch on the card, up to
    ``MAX_LEAVES`` leaves). Returns the folded pytree in the grads' dtypes."""
    leaves, ids = tree_leaves(grads), tree_leaves(layer_ids)
    flat = [g.reshape(g.shape[0], *leaf_dims(g.shape[1:], i)).contiguous()
            for g, i in zip(leaves, ids)]
    out: list = [None] * len(leaves)
    for dtype in dict.fromkeys(g.dtype for g in leaves):
        idx = [k for k, g in enumerate(leaves) if g.dtype == dtype]
        folded = adel_agg_grouped([flat[k] for k in idx],
                                  [ids[k] for k in idx], coeffs)
        for k, o in zip(idx, folded):
            out[k] = o.reshape(leaves[k].shape[1:])
    return tree_unflatten(grads, out)


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
    return fold_tree(grads, layer_ids, coeffs)
