"""Delta compression for the client -> server wire (int8 / top-k payloads),
in PyTorch (port of ``repro.core.compression``).

* ``int8`` — symmetric absmax quantization with one float32 scale per
  (client, layer): ``scale[u, l] = max_f |d[u, l, f]| / 127``,
  ``q = round(d * 127 / amax)`` (round half to even, as ``jnp.rint``).
  4 bytes/element -> 1 byte.
* ``topk8`` — per-(client, layer) top-k by magnitude over the flattened
  feature dim, int8 values + int32 indices, same absmax scale.

Every leaf is handled in the canonical kernel layout (U, L_leaf, F)
(:func:`repro_torch.kernels.ops.leaf_dims`). Aggregation folds the Eq. 5
coefficient into the dequant scale, so dequantize + weight + accumulate is
one pass: for int8 every leaf of the payload in one call of the
hand-written grouped kernel ``adel_agg_q8_grouped`` (one launch a round on
the card, each leaf's weights read from the (U, L) coefficients through its
layer ids), a plain ``scatter_add_`` per leaf for topk8 (the reference
keeps that a jnp scatter too).

The payload is a flat list, in params-tree leaf order (dict keys sorted,
as ``jax.tree.flatten``), of per-leaf tuples ``(q, scale)`` or
``(q, scale, idx)``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.kernels.adel_agg import adel_agg_q8_grouped
from repro_torch.kernels.ops import leaf_coeff_rows, leaf_dims
from repro_torch.tree import tree_leaves, tree_unflatten

__all__ = ["CompressionConfig", "make_compression", "compress_deltas",
           "aggregate_compressed", "payload_bytes"]

PyTree = Any

MODES = ("none", "int8", "topk8")


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    """Client->server payload compression spec. ``mode``: "none" | "int8"
    | "topk8"; ``top_k``: kept fraction of the flattened feature dim per
    (client, layer) in topk8 mode."""
    mode: str = "none"
    top_k: float = 0.05

    def __post_init__(self):
        assert self.mode in MODES, f"unknown compression mode {self.mode!r}"
        assert 0.0 < self.top_k <= 1.0

    def wire_scale(self) -> float:
        """Expected wire bytes as a fraction of the dense float32 payload
        (the ``comm_scale`` the Problem-2 cost model prices B_u with)."""
        if self.mode == "int8":
            return 0.25
        if self.mode == "topk8":
            return 1.25 * self.top_k          # 1B value + 4B index per kept
        return 1.0


def make_compression(spec) -> CompressionConfig:
    """None | mode string | (mode, top_k) | CompressionConfig -> config."""
    if spec is None:
        return CompressionConfig()
    if isinstance(spec, CompressionConfig):
        return spec
    if isinstance(spec, str):
        return CompressionConfig(mode=spec)
    mode, top_k = spec
    return CompressionConfig(mode=mode, top_k=float(top_k))


def _leaf_k(F: int, cfg: CompressionConfig) -> int:
    return max(1, min(F, int(math.ceil(cfg.top_k * F))))


def _compress_leaf(g: torch.Tensor, ids, cfg: CompressionConfig):
    """One delta leaf (U,) + param.shape -> wire tuple in (U, Ll, F) form."""
    U = g.shape[0]
    Ll, F = leaf_dims(g.shape[1:], ids)
    flat = g.reshape(U, Ll, F).to(torch.float32)
    amax = flat.abs().amax(dim=-1)                               # (U, Ll)
    scale = amax / 127.0
    inv = torch.where(amax > 0, 127.0 / amax, torch.zeros_like(amax))
    if cfg.mode == "int8":
        q = torch.round(flat * inv[..., None]).to(torch.int8)
        return (q, scale)
    _, idx = torch.topk(flat.abs(), _leaf_k(F, cfg), dim=-1)      # (U, Ll, k)
    vals = torch.gather(flat, -1, idx)
    q = torch.round(vals * inv[..., None]).to(torch.int8)
    return (q, scale, idx.to(torch.int32))


def compress_deltas(deltas: PyTree, layer_ids: PyTree,
                    cfg: CompressionConfig) -> list:
    """Compress a stacked delta pytree (leading client axis U on every leaf)
    into the wire payload: a flat list of ``(q int8 (U, Ll, F), scale f32
    (U, Ll))`` tuples, plus ``idx int32 (U, Ll, K)`` in topk8 mode."""
    return [_compress_leaf(g, i, cfg)
            for g, i in zip(tree_leaves(deltas), tree_leaves(layer_ids))]


def _agg_topk(entry, shape, ids, c: torch.Tensor) -> torch.Tensor:
    w = leaf_coeff_rows(c, ids)                                  # (U, Ll)
    Ll, F = leaf_dims(shape, ids)
    q, scale, idx = entry
    U, _, k = q.shape
    contrib = (w * scale)[..., None] * q.to(torch.float32)       # (U, Ll, k)
    out = torch.zeros((Ll, F), dtype=torch.float32, device=q.device)
    out.scatter_add_(1, idx.permute(1, 0, 2).reshape(Ll, U * k).long(),
                     contrib.permute(1, 0, 2).reshape(Ll, U * k))
    return out.reshape(shape)


def aggregate_compressed(payload: list, params: PyTree, layer_ids: PyTree,
                         mask: torch.Tensor | None, p: torch.Tensor | None, *,
                         cfg: CompressionConfig,
                         counts: torch.Tensor | None = None,
                         coeffs: torch.Tensor | None = None,
                         bias_correct: bool = True) -> PyTree:
    """Fused dequantize + Eq. 5 weight + accumulate over the wire payload.

    Returns the aggregated float32 delta pytree (params structure, no
    client axis). ``counts`` supplies GLOBAL per-layer contributor counts;
    ``coeffs`` overrides the Eq. 5 coefficients. ``params`` supplies leaf
    shapes only.
    """
    from repro_torch.core.aggregation import layer_coefficients
    if coeffs is None:
        coeffs = layer_coefficients(mask, p, bias_correct=bias_correct,
                                    counts=counts)
    leaves, ids = tree_leaves(params), tree_leaves(layer_ids)
    if cfg.mode == "topk8":
        out = [_agg_topk(e, pl.shape, i, coeffs)
               for e, pl, i in zip(payload, leaves, ids)]
    else:
        folded = adel_agg_q8_grouped([q.contiguous() for q, _ in payload],
                                     [s for _, s in payload], ids, coeffs)
        out = [o.reshape(pl.shape) for o, pl in zip(folded, leaves)]
    return tree_unflatten(params, out)


def payload_bytes(params: PyTree, layer_ids: PyTree, U: int,
                  cfg: CompressionConfig) -> tuple[int, int]:
    """Deterministic analytic (logical, wire) byte counts for a U-client
    round payload: ``logical`` is the dense float32 delta pytree, ``wire``
    what the compressed payload ships (int8 values + float32 per-(client,
    layer) scales, + int32 indices in topk8 mode)."""
    logical = wire = 0
    for pleaf, ids in zip(tree_leaves(params), tree_leaves(layer_ids)):
        Ll, F = leaf_dims(tuple(pleaf.shape), ids)
        logical += 4 * Ll * F
        if cfg.mode == "int8":
            wire += Ll * F + 4 * Ll
        elif cfg.mode == "topk8":
            wire += 5 * Ll * _leaf_k(F, cfg) + 4 * Ll
        else:
            wire += 4 * Ll * F
    return U * logical, U * wire
