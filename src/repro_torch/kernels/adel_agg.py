"""ADEL-FL's layer-wise Eq. 5 fold: hand-written CUDA kernels for Hopper
(``csrc/adel_agg.cu``) and their plain PyTorch versions.

* :func:`adel_agg` replaces ``repro/kernels/adel_agg.py:adel_agg``:
  ``out[l, f] = sum_u coeff[u, l] * grads[u, l, f]``, grads (U, L, F) f32 or
  bf16, coeff (U, L), f32 accumulation, output (L, F) in the grads dtype.
* :func:`adel_agg_q8` replaces ``repro/kernels/adel_agg.py:adel_agg_q8``:
  the fused int8 dequantize + weight + accumulate
  ``out[l, f] = sum_u coeff[u, l] * scales[u, l] * q[u, l, f]``, output f32.

Bound on an H100 SXM (3.35 TB/s): both are memory-bound. ``adel_agg``
moves ``(U + 1) * L * F * itemsize`` bytes, ``adel_agg_q8`` ``U * L * F +
4 * L * F`` bytes; the arithmetic (2 flops per input element) is far below
the card's ridge point. The kernels stream each input byte once with 16-byte
coalesced loads, keep the sums in f32 registers, stage the (U,) weight
column in shared memory, and mask the ragged F edge without a padding copy
(the source's header has the details).

:func:`adel_agg_grouped` is the fold of a round: every leaf of one dtype,
each (U, L_leaf, F) with its layer ids, against the full (U, L) coefficient
matrix, in one launch of ``fold_grouped_kernel`` (a launch holds
``MAX_LEAVES`` leaves; :func:`fold_plan` is its block map). The pytree fold
(``kernels/ops.py:fold_tree``) goes through it; the single-tensor
:func:`adel_agg` stays the counterpart of the reference's ``adel_agg``.
:func:`adel_agg_q8_grouped` is the same for a compressed round's int8
leaves, each with its (U, L_leaf) scales (``fold_grouped_q8_kernel``,
``MAX_LEAVES_Q8`` leaves a launch); ``core/compression.py`` goes through
it, and :func:`adel_agg_q8` stays the single-tensor counterpart. Both
share the table code (:func:`_fold_grouped`); the block map is memoised.

On a CUDA tensor a wrapper launches its kernel or raises; on a CPU tensor
it computes the plain version (an einsum in f32), which is also what
``chip_smoke.py`` holds each kernel against on the card; on a ``meta``
tensor (the dry run, ``launch/dryrun.py``) it takes the plain version's
shapes and computes nothing. Each wrapper
counts its launches in ``.launches``: the grouped wrappers count their
launches, one per table.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels.build import PLAIN_DEVICES, load_library

__all__ = ["adel_agg", "adel_agg_q8", "adel_agg_plain", "adel_agg_q8_plain",
           "adel_agg_grouped", "adel_agg_grouped_plain", "adel_agg_q8_grouped",
           "adel_agg_q8_grouped_plain", "leaf_coeff_rows", "fold_plan",
           "fold_tile", "table_leaves", "block_tile", "MAX_LEAVES",
           "MAX_LEAVES_Q8"]

_LIB = "adel_agg"
_MAX_U = 12 * 1024            # (U,) f32 weights in 48 KB of shared memory
_MAX_L = 65535                # grid.y
# the grouped fold's table and tiles, as csrc/adel_agg.cu defines them
MAX_LEAVES = 64               # leaves one launch's table holds
MAX_LEAVES_Q8 = 63            # int8 leaves one launch's table holds
FOLD_THREADS = 256            # threads a block
FOLD_VECS = 2                 # 16-byte vectors a thread owns in a row
FOLD_VECS_Q8 = 1              # 16-int8 vectors a thread owns in a row


def adel_agg_plain(grads: torch.Tensor, coeff: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch Eq. 5 fold, the kernel's reference: (L, F) in grads' dtype."""
    return torch.einsum("ul,ulf->lf", coeff.to(torch.float32),
                        grads.to(torch.float32)).to(grads.dtype)


def adel_agg_q8_plain(q: torch.Tensor, scales: torch.Tensor,
                      coeff: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch fused int8 fold, the kernel's reference: (L, F) f32."""
    w = coeff.to(torch.float32) * scales.to(torch.float32)
    return torch.einsum("ul,ulf->lf", w, q.to(torch.float32))


def _check(x: torch.Tensor, weights: tuple[torch.Tensor, ...], dtypes) -> tuple:
    if x.dim() != 3:
        raise ValueError(f"expected a (U, L, F) tensor, got {tuple(x.shape)}")
    if x.dtype not in dtypes:
        raise TypeError(f"unsupported dtype {x.dtype}; takes {dtypes}")
    U, L, F = x.shape
    if not 1 <= U <= _MAX_U or not 1 <= L <= _MAX_L or F < 1:
        raise ValueError(f"shape {tuple(x.shape)} outside U <= {_MAX_U}, "
                         f"L <= {_MAX_L}, F >= 1")
    if not x.is_contiguous():
        raise ValueError("the (U, L, F) input must be contiguous")
    for w in weights:
        if w.shape != (U, L):
            raise ValueError(f"weights {tuple(w.shape)} != {(U, L)}")
        if w.device != x.device:
            raise ValueError(f"weights on {w.device}, input on {x.device}")
    return U, L, F


def _f32(w: torch.Tensor) -> torch.Tensor:
    return w.to(torch.float32).contiguous()


def _launch(fn, *args) -> None:
    err = fn(*args, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        raise RuntimeError(f"CUDA kernel launch failed: error {err}")


@functools.lru_cache(maxsize=None)
def _kernel(name: str):
    """The C entry point ``name`` of the built library, with its signature:
    ``n`` data pointers, then (int U, int L, long long F, stream)."""
    n_ptr = 4 if name == "adel_agg_q8" else 3
    fn = getattr(load_library(_LIB), name)
    fn.argtypes = ([ctypes.c_void_p] * n_ptr
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def adel_agg(grads: torch.Tensor, coeff: torch.Tensor) -> torch.Tensor:
    """grads (U, L, F) f32/bf16, coeff (U, L) -> (L, F) in grads' dtype."""
    if grads.device.type in PLAIN_DEVICES:
        return adel_agg_plain(grads, coeff)
    if grads.device.type != "cuda":
        raise ValueError(f"adel_agg runs on CUDA, CPU or meta, not {grads.device}")
    U, L, F = _check(grads, (coeff,), (torch.float32, torch.bfloat16))
    c = _f32(coeff)
    with torch.cuda.device(grads.device):
        out = torch.empty((L, F), dtype=grads.dtype, device=grads.device)
        name = "adel_agg_f32" if grads.dtype == torch.float32 else "adel_agg_bf16"
        _launch(_kernel(name), grads.data_ptr(), c.data_ptr(),
                out.data_ptr(), U, L, F)
    adel_agg.launches += 1
    return out


def adel_agg_q8(q: torch.Tensor, scales: torch.Tensor,
                coeff: torch.Tensor) -> torch.Tensor:
    """q (U, L, F) int8, scales and coeff (U, L) -> (L, F) f32."""
    if q.device.type in PLAIN_DEVICES:
        return adel_agg_q8_plain(q, scales, coeff)
    if q.device.type != "cuda":
        raise ValueError(f"adel_agg_q8 runs on CUDA, CPU or meta, not {q.device}")
    U, L, F = _check(q, (scales, coeff), (torch.int8,))
    s, c = _f32(scales), _f32(coeff)
    with torch.cuda.device(q.device):
        out = torch.empty((L, F), dtype=torch.float32, device=q.device)
        _launch(_kernel("adel_agg_q8"), q.data_ptr(), s.data_ptr(),
                c.data_ptr(), out.data_ptr(), U, L, F)
    adel_agg_q8.launches += 1
    return out


# ---------------------------------------------------------------------------
# the grouped folds: one launch a round
# ---------------------------------------------------------------------------

def _ids_ndim(ids) -> int:
    return ids.dim() if isinstance(ids, torch.Tensor) else 0


def leaf_coeff_rows(c: torch.Tensor, ids) -> torch.Tensor:
    """The Eq. 5 coefficient rows of one leaf: (U, L_leaf), contiguous."""
    if _ids_ndim(ids) == 0:
        return c[:, int(ids)].unsqueeze(1).contiguous()
    return c.index_select(1, ids.to(device=c.device, dtype=torch.long))


def adel_agg_grouped_plain(leaves: list, ids: list,
                           coeff: torch.Tensor) -> list:
    """Plain PyTorch grouped fold: each leaf through :func:`adel_agg_plain`
    with its coefficient rows gathered from ``coeff``."""
    return [adel_agg_plain(x, leaf_coeff_rows(coeff, i).to(torch.float32))
            for x, i in zip(leaves, ids)]


def adel_agg_q8_grouped_plain(qs: list, scales: list, ids: list,
                              coeff: torch.Tensor) -> list:
    """Plain PyTorch grouped int8 fold: each leaf through
    :func:`adel_agg_q8_plain` with its coefficient rows gathered from
    ``coeff``."""
    return [adel_agg_q8_plain(q, s, leaf_coeff_rows(coeff, i))
            for q, s, i in zip(qs, scales, ids)]


class FoldEntry(NamedTuple):
    """One leaf of a launch's table: its index in the caller's list, its
    first block, and its feature tiles a row (blocks = rows x tiles)."""
    leaf: int
    tile0: int
    tiles: int
    rows: int


def table_leaves(itemsize: int) -> int:
    """Leaves one launch's table holds: ``MAX_LEAVES_Q8`` int8 leaves (an
    entry also carries the scales), else ``MAX_LEAVES``."""
    return MAX_LEAVES_Q8 if itemsize == 1 else MAX_LEAVES


def fold_tile(itemsize: int) -> int:
    """Elements of F a block folds for one row: threads x vectors x
    16-byte vector (2,048 f32, 4,096 bf16, 4,096 int8)."""
    vecs = FOLD_VECS_Q8 if itemsize == 1 else FOLD_VECS
    return FOLD_THREADS * vecs * (16 // itemsize)


def fold_plan(dims, itemsize: int) -> tuple:
    """The grouped fold's launches for leaves of (rows, F) ``dims``: a tuple
    of (entries, blocks), one per launch of at most
    :func:`table_leaves` leaves. Leaves go largest first, so the small ones
    fill the last wave; a leaf with no elements is left out (its output is
    empty). Block b of a launch folds the (leaf, row, feature tile) that
    :func:`block_tile` gives. A pure function of its arguments, memoised: a
    round of the same model only refills the tables' pointers."""
    return _fold_plan(tuple(map(tuple, dims)), itemsize)


@functools.lru_cache(maxsize=64)
def _fold_plan(dims: tuple, itemsize: int) -> tuple:
    tile, max_leaves = fold_tile(itemsize), table_leaves(itemsize)
    work = [(rows * -(-F // tile), i) for i, (rows, F) in enumerate(dims)
            if rows * F > 0]
    order = [i for _, i in sorted(work, key=lambda t: (-t[0], t[1]))]
    launches = []
    for start in range(0, len(order), max_leaves):
        entries, blocks = [], 0
        for i in order[start:start + max_leaves]:
            rows, F = dims[i]
            tiles = -(-F // tile)
            entries.append(FoldEntry(i, blocks, tiles, rows))
            blocks += rows * tiles
        launches.append((tuple(entries), blocks))
    return tuple(launches)


def block_tile(entries, block: int) -> tuple:
    """(leaf, row, feature tile) of ``block``, as the kernel finds it: a
    binary search for the last entry whose first block is <= ``block``."""
    lo, hi = 0, len(entries) - 1
    while lo < hi:
        mid = (lo + hi + 1) >> 1
        if entries[mid].tile0 <= block:
            lo = mid
        else:
            hi = mid - 1
    e = entries[lo]
    row, tile = divmod(block - e.tile0, e.tiles)
    return e.leaf, row, tile


class _FoldLeaf(ctypes.Structure):
    _fields_ = [("x", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("ids", ctypes.c_void_p), ("F", ctypes.c_longlong),
                ("tile0", ctypes.c_longlong), ("tiles", ctypes.c_int),
                ("id0", ctypes.c_int), ("rows", ctypes.c_int),
                ("vec", ctypes.c_int)]


class _FoldQ8Leaf(ctypes.Structure):
    _fields_ = [("leaf", _FoldLeaf), ("scales", ctypes.c_void_p)]


_TABLE_HEADER = [("coeff", ctypes.c_void_p), ("U", ctypes.c_int),
                 ("L", ctypes.c_int), ("n", ctypes.c_int),
                 ("pad", ctypes.c_int)]


class _FoldTable(ctypes.Structure):
    _fields_ = _TABLE_HEADER + [("leaf", _FoldLeaf * MAX_LEAVES)]


class _FoldQ8Table(ctypes.Structure):
    _fields_ = _TABLE_HEADER + [("leaf", _FoldQ8Leaf * MAX_LEAVES_Q8)]


@functools.lru_cache(maxsize=None)
def _grouped_kernel(dtype: torch.dtype):
    """The grouped entry of the built library for leaves of ``dtype``,
    once its table size, leaves and tile agree with this module's."""
    lib = load_library(_LIB)
    q8 = dtype == torch.int8
    prefix = "adel_agg_q8_grouped" if q8 else "adel_agg_grouped"
    table = _FoldQ8Table if q8 else _FoldTable
    for name, restype, want in (
            (f"{prefix}_table_bytes", ctypes.c_longlong, ctypes.sizeof(table)),
            (f"{prefix}_max_leaves", ctypes.c_int,
             table_leaves(1 if q8 else 4))):
        getattr(lib, name).restype = restype
        if getattr(lib, name)() != want:
            raise RuntimeError(f"{name} of the built library is not {want}")
    tile = getattr(lib, f"{prefix}_tile")
    tile.restype = ctypes.c_int
    if q8:
        tile.argtypes = []
        tiles_agree = tile() == fold_tile(1)
    else:
        tile.argtypes = [ctypes.c_int]
        tiles_agree = all(tile(i) == fold_tile(i) for i in (2, 4))
    if not tiles_agree:
        raise RuntimeError("the library's fold tile is not fold_tile()")
    fn = (lib.adel_agg_q8_grouped if q8 else lib.adel_agg_grouped_f32
          if dtype == torch.float32 else lib.adel_agg_grouped_bf16)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, table


def _layer_rows(ids, rows: int, L: int, device) -> tuple:
    """(id0, ids tensor or None) of one leaf: layer of row i is
    ``ids[i]`` if a tensor is returned, else ``id0 + i``. A scalar id or a
    host-side range costs nothing on the device; a stacked id vector on the
    device is read there (as int32); any other host vector is copied over."""
    if _ids_ndim(ids) == 0:
        i = int(ids)
        if not 0 <= i < L or rows != 1:
            raise ValueError(f"layer id {i} of a whole-tensor leaf outside "
                             f"[0, {L}) or leaf rows {rows} != 1")
        return i, None
    if ids.shape != (rows,):
        raise ValueError(f"layer ids {tuple(ids.shape)} != ({rows},)")
    if rows == 0:
        return 0, None
    if ids.device.type == "cpu":
        vals = ids.to(torch.long)
        if not (0 <= int(vals.min()) and int(vals.max()) < L):
            raise ValueError(f"layer ids outside [0, {L})")
        if torch.equal(vals, torch.arange(int(vals[0]), int(vals[0]) + rows)):
            return int(vals[0]), None
    return 0, ids.to(device=device, dtype=torch.int32).contiguous()


def _check_leaves(name: str, leaves: list, coeff: torch.Tensor,
                  dtypes: tuple) -> None:
    """Every leaf (U, L_leaf, F) of one dtype in ``dtypes``, contiguous, on
    coeff's device, coeff (U, L)."""
    dtype, U, dev = leaves[0].dtype, leaves[0].shape[0], leaves[0].device
    if dtype not in dtypes:
        raise TypeError(f"unsupported dtype {dtype}; {name} takes {dtypes}")
    if coeff.dim() != 2 or coeff.shape[0] != U or coeff.device != dev:
        raise ValueError(f"coeff {tuple(coeff.shape)} on {coeff.device} is "
                         f"not (U={U}, L) on {dev}")
    for x in leaves:
        if x.dim() != 3 or x.shape[0] != U or x.dtype != dtype:
            raise ValueError(f"leaf {tuple(x.shape)} {x.dtype} is not "
                             f"(U={U}, L_leaf, F) {dtype}")
        if x.device != dev or not x.is_contiguous():
            raise ValueError("every leaf must be contiguous, on one device")


def _fold_grouped(leaves: list, ids: list, coeff: torch.Tensor,
                  out_dtype: torch.dtype, counter, scales=None) -> list:
    """Launch the grouped fold of checked ``leaves``, one launch per table
    of :func:`fold_plan`, each counted on ``counter.launches``; with
    ``scales`` (int8 leaves) the table is the int8 one. Returns each leaf's
    (L_leaf, F) output of ``out_dtype``, all in one buffer, each starting
    on a 16-byte boundary."""
    dev = leaves[0].device
    U, L = coeff.shape
    c = _f32(coeff)
    itemsize = leaves[0].element_size()
    vn, out_vn = 16 // itemsize, 16 // out_dtype.itemsize
    dims = [tuple(x.shape[1:]) for x in leaves]
    offs, total = [], 0
    for rows, F in dims:
        offs.append(total)
        total += -(-rows * F // out_vn) * out_vn
    layer = [_layer_rows(i, rows, L, dev) for (rows, _), i in zip(dims, ids)]
    fn, table_type = _grouped_kernel(leaves[0].dtype)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    with torch.cuda.device(dev):
        buf = torch.empty(max(total, 1), dtype=out_dtype, device=dev)
        outs = [buf.as_strided((rows, F), (F, 1), o)
                for o, (rows, F) in zip(offs, dims)]
        x_at = [x.data_ptr() for x in leaves]
        out_at = [buf.data_ptr() + o * out_dtype.itemsize for o in offs]
        for entries, blocks in fold_plan(dims, itemsize):
            table = table_type(coeff=c.data_ptr(), U=U, L=L, n=len(entries))
            for k, e in enumerate(entries):
                i = e.leaf
                id0, idv = layer[i]
                F = dims[i][1]
                vec = (F % vn == 0 and x_at[i] % 16 == 0
                       and out_at[i] % 16 == 0)
                leaf = _FoldLeaf(x_at[i], out_at[i],
                                 None if idv is None else idv.data_ptr(), F,
                                 e.tile0, e.tiles, id0, e.rows, int(vec))
                table.leaf[k] = (leaf if scales is None else
                                 _FoldQ8Leaf(leaf, scales[i].data_ptr()))
            err = fn(ctypes.byref(table), blocks, stream)
            if err != 0:
                raise RuntimeError(f"{counter.__name__} launch failed: error "
                                   f"{err}")
            counter.launches += 1
    return outs


def adel_agg_grouped(leaves: list, ids: list, coeff: torch.Tensor) -> list:
    """Fold every leaf of one dtype in one launch: ``leaves`` (U, L_leaf, F)
    f32 or bf16 tensors, contiguous; ``ids`` each leaf's layer ids, an int
    (L_leaf = 1) or an (L_leaf,) integer tensor in [0, L); ``coeff`` (U, L).
    Returns each leaf's (L_leaf, F) fold in its dtype. More than
    ``MAX_LEAVES`` leaves take one launch per ``MAX_LEAVES``."""
    if not leaves:
        return []
    dev = leaves[0].device
    if dev.type in PLAIN_DEVICES:
        return adel_agg_grouped_plain(leaves, ids, coeff)
    if dev.type != "cuda":
        raise ValueError(f"adel_agg_grouped runs on CUDA, CPU or meta, not {dev}")
    _check_leaves("adel_agg_grouped", leaves, coeff,
                  (torch.float32, torch.bfloat16))
    return _fold_grouped(leaves, ids, coeff, leaves[0].dtype,
                         adel_agg_grouped)


def adel_agg_q8_grouped(qs: list, scales: list, ids: list,
                        coeff: torch.Tensor) -> list:
    """Fold every int8 leaf of a compressed round in one launch: ``qs``
    (U, L_leaf, F) int8 codes, contiguous; ``scales`` each leaf's
    (U, L_leaf) dequantization scales; ``ids`` each leaf's layer ids, an
    int (L_leaf = 1) or an (L_leaf,) integer tensor in [0, L); ``coeff``
    (U, L). Returns each leaf's (L_leaf, F) f32 fold
    ``sum_u coeff[u, id] * scales[u, row] * q[u, row, f]``. More than
    ``MAX_LEAVES_Q8`` leaves take one launch per ``MAX_LEAVES_Q8``."""
    if not qs:
        return []
    dev = qs[0].device
    if dev.type in PLAIN_DEVICES:
        return adel_agg_q8_grouped_plain(qs, scales, ids, coeff)
    if dev.type != "cuda":
        raise ValueError(f"adel_agg_q8_grouped runs on CUDA, CPU or meta, not {dev}")
    _check_leaves("adel_agg_q8_grouped", qs, coeff, (torch.int8,))
    if len(scales) != len(qs):
        raise ValueError(f"{len(scales)} scales for {len(qs)} leaves")
    scales = [_f32(s) for s in scales]
    for q, s in zip(qs, scales):
        if s.shape != q.shape[:2] or s.device != dev:
            raise ValueError(f"scales {tuple(s.shape)} on {s.device} are not "
                             f"{tuple(q.shape[:2])} on {dev}")
    return _fold_grouped(qs, ids, coeff, torch.float32, adel_agg_q8_grouped,
                         scales)


adel_agg.launches = 0
adel_agg_q8.launches = 0
adel_agg_grouped.launches = 0
adel_agg_q8_grouped.launches = 0
