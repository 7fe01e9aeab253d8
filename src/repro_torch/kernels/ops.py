"""Wrappers bridging model layouts to the kernels (port of
``repro.kernels.ops``):

* :func:`gqa_flash` — attention in the model's (B, S, H, hd) layout through
  the flash attention kernel, read through strides (no copies);
* :func:`ssd_chunked_kernel` — the Mamba2 SSD mixer's scan in the model's
  layout through the SSD chunk-scan kernel;
* :func:`adel_aggregate` — the Eq. 5 fold of a params pytree through the
  fold kernel.

Like the kernel wrappers they call, each launches its kernel for CUDA
tensors and computes the plain version for CPU tensors.

The fold:

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
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.tree import tree_map

__all__ = ["gqa_flash", "ssd_chunked_kernel", "leaf_dims", "leaf_coeff_rows",
           "fold_leaf", "adel_aggregate"]

PyTree = Any


def gqa_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0) -> torch.Tensor:
    """Model layout (B, S, H, hd) / (B, S, KV, hd) -> (B, S, H, hd). The
    kernel reads the (B, H, S, hd) views through their strides and writes
    its output in q's layout, so on the card nothing is copied and the
    caller's ``reshape(B, S, H * hd)`` is a view."""
    return flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), causal=causal,
                           window=window).transpose(1, 2)


def ssd_chunked_kernel(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       b: torch.Tensor, c: torch.Tensor, *,
                       chunk: int = 64) -> torch.Tensor:
    """Model layout: x (B,S,H,P); dt (B,S,H); A (H,); b,c (B,S,N) -> y
    (B,S,H,P) in x's dtype (the skip term stays with the caller). Pre-scales
    ``xdt = x * dt`` and ``la = -A * dt`` in f32; ``b`` and ``c`` go to the
    kernel per batch (G = B), not copied out per head."""
    B, S, H, P = x.shape
    f32 = torch.float32
    xdt = (x.to(f32) * dt[..., None]).transpose(1, 2).reshape(B * H, S, P)
    la = (-A[None, None, :] * dt).to(f32).transpose(1, 2).reshape(B * H, S)
    y = ssd_scan(xdt.contiguous(), la.contiguous(), b.to(f32).contiguous(),
                 c.to(f32).contiguous(), chunk=chunk)
    return y.reshape(B, H, S, P).transpose(1, 2).to(x.dtype)


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
