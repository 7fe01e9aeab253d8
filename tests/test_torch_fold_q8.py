"""The grouped int8 fold (``repro_torch.kernels.adel_agg.adel_agg_q8_grouped``)
and the compressed round's aggregation through it, against the reference's
Pallas path run in interpret mode.

On these CPU tensors the fold computes its plain version. The host side of
the one launch a round (the leaf tables, filled by ``_fold_grouped``) is
run here too, with the launch replaced by an emulation of
``fold_grouped_q8_kernel``: each block finds its leaf with ``block_tile``
(the kernel's binary search) and folds its tile through the pointers, ids
and scales of its table entry, so a mistake in the table shows as a wrong
fold. The CUDA kernel is held against the plain version on the card by
``chip_smoke.py`` and ``tests/test_torch_gpu.py``. Tolerance: rtol 2e-5 /
atol 1e-6, as the f32 pytree folds (f32 sums in another order).
"""
import contextlib
import ctypes
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as rcomp
from repro_torch.core import compression as pcomp
from repro_torch.core.aggregation import layer_coefficients
from repro_torch.kernels.adel_agg import (MAX_LEAVES_Q8, adel_agg_q8_grouped,
                                          adel_agg_q8_grouped_plain,
                                          fold_plan, fold_tile)
from repro_torch.tree import tree_leaves

A = importlib.import_module("repro_torch.kernels.adel_agg")
TOL = dict(rtol=2e-5, atol=1e-6)


def _quantize(g):
    """The wire's int8 absmax quantization of (U, L, F) deltas, in numpy:
    (codes, scales), a zero scale for an all-zero row."""
    amax = np.abs(g).max(-1)
    inv = np.where(amax > 0, np.float32(127.0) / np.maximum(amax, 1e-30), 0.0)
    q = np.rint(g * inv[..., None].astype(np.float32)).astype(np.int8)
    return q, (amax / np.float32(127.0)).astype(np.float32)


def _mixed(U, L, n_many, seed=0):
    """A params pytree with stacked and scalar layer ids, F = 1, F % 16 != 0
    and F % 16 == 0, an all-zero (zero-scale) leaf, and ``n_many`` small
    leaves; with its int8 payload in leaf order. Returns (params, ids,
    payload) as numpy (params give leaf shapes only)."""
    rng = np.random.default_rng(seed)
    params = {"blocks": {"w": np.zeros((L, 6, 5)), "b": np.zeros((L, 3))},
              "head": np.zeros((7, 9)), "one": np.zeros((1,)),
              "wide": np.zeros((2, 48)), "zero": np.zeros((33,)),
              "many": [np.zeros((17 + k % 3,)) for k in range(n_many)]}
    ids = {"blocks": {"w": np.arange(L), "b": np.arange(L)[::-1].copy()},
           "head": L - 1, "one": 0, "wide": 1 % L, "zero": 2 % L,
           "many": [k % L for k in range(n_many)]}
    payload = []
    for leaf, i in zip(tree_leaves(params), tree_leaves(ids)):
        Ll = leaf.shape[0] if isinstance(i, np.ndarray) else 1
        g = rng.standard_normal((U, Ll, leaf.size // Ll))
        if leaf.shape == (33,):
            g[:] = 0.0
        payload.append(_quantize(g.astype(np.float32)))
    return params, ids, payload


def _torch_ids(ids):
    if isinstance(ids, dict):
        return {k: _torch_ids(v) for k, v in ids.items()}
    if isinstance(ids, list):
        return [_torch_ids(v) for v in ids]
    return torch.from_numpy(ids) if isinstance(ids, np.ndarray) else int(ids)


def _jax_tree(tree, leaf):
    if isinstance(tree, dict):
        return {k: _jax_tree(v, leaf) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_jax_tree(v, leaf) for v in tree]
    return leaf(tree)


@pytest.mark.parametrize("coeffs", ["mask", "override"])
def test_int8_aggregate_matches_pallas_on_a_mixed_pytree(coeffs):
    """The port's int8 ``aggregate_compressed`` (all leaves in one grouped
    fold) against the reference's ``agg_impl="pallas"`` path: scalar and
    stacked ids, a zero-scale leaf, zero-coefficient clients, F = 1,
    F % 16 != 0, and more leaves than one int8 table holds."""
    U, L = 5, 4
    params, ids, payload = _mixed(U, L, n_many=MAX_LEAVES_Q8 + 2)
    assert len(payload) > MAX_LEAVES_Q8
    rng = np.random.default_rng(1)
    mask = (rng.uniform(size=(U, L)) > 0.3).astype(np.float32)
    mask[0] = 0.0                                 # a client that sent nothing
    p = np.full((L,), 0.1, np.float32)
    c = np.asarray(layer_coefficients(torch.from_numpy(mask),
                                      torch.from_numpy(p)))
    if coeffs == "override":
        c[:, 1] = 0.0                             # a layer nobody folds into
    cfg, rcfg = pcomp.make_compression("int8"), rcomp.make_compression("int8")
    kw = (dict(coeffs=jnp.asarray(c)) if coeffs == "override" else {})
    ref = rcomp.aggregate_compressed(
        [(jnp.asarray(q), jnp.asarray(s)) for q, s in payload],
        _jax_tree(params, lambda a: jnp.asarray(a, jnp.float32)),
        _jax_tree(ids, jnp.asarray), jnp.asarray(mask), jnp.asarray(p),
        cfg=rcfg, agg_impl="pallas", interpret=True, **kw)
    kw = (dict(coeffs=torch.from_numpy(c)) if coeffs == "override" else {})
    before = adel_agg_q8_grouped.launches
    out = pcomp.aggregate_compressed(
        [(torch.from_numpy(q), torch.from_numpy(s)) for q, s in payload],
        _jax_tree(params, torch.from_numpy), _torch_ids(ids),
        torch.from_numpy(mask), torch.from_numpy(p), cfg=cfg, **kw)
    assert adel_agg_q8_grouped.launches == before      # CPU: no launch
    outs, refs = tree_leaves(out), tree_leaves(ref)
    assert len(outs) == len(refs) == len(payload)
    for o, r in zip(outs, refs):
        assert o.dtype == torch.float32 and tuple(o.shape) == r.shape
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **TOL)
    assert torch.equal(out["zero"], torch.zeros(33))


def test_q8_grouped_on_cpu_is_plain_and_counts_nothing():
    """On CPU tensors the grouped int8 entry computes each leaf's plain fold
    and launches nothing."""
    gen = torch.Generator().manual_seed(0)
    qs = [torch.randint(-127, 128, (4, 1, 300), generator=gen,
                        dtype=torch.int8),
          torch.randint(-127, 128, (4, 3, 7), generator=gen,
                        dtype=torch.int8)]
    scales = [torch.rand((4, 1), generator=gen),
              torch.rand((4, 3), generator=gen)]
    ids = [2, torch.tensor([0, 2, 1])]
    c = torch.rand((4, 3), generator=gen)
    before = (adel_agg_q8_grouped.launches, A.adel_agg_q8.launches)
    outs = adel_agg_q8_grouped(qs, scales, ids, c)
    assert (adel_agg_q8_grouped.launches, A.adel_agg_q8.launches) == before
    for out, ref in zip(outs, adel_agg_q8_grouped_plain(qs, scales, ids, c)):
        assert out.dtype == torch.float32 and torch.equal(out, ref)
    # the plain version is the per-leaf single-tensor fold
    for out, q, s, i in zip(outs, qs, scales, ids):
        w = A.leaf_coeff_rows(c, i)
        assert torch.equal(out, A.adel_agg_q8_plain(q, s, w))
    assert adel_agg_q8_grouped([], [], [], c) == []


# ---------------------------------------------------------------------------
# the leaf tables, through an emulation of the kernel
# ---------------------------------------------------------------------------

def _at(ptr: int, n: int, ctype) -> torch.Tensor:
    """The n elements of host memory at ``ptr``, as a tensor (no copy)."""
    return torch.from_numpy(np.ctypeslib.as_array((ctype * n).from_address(
        ptr)))


def _emulate_q8(calls: list):
    """A stand-in for the library's grouped int8 entry: decodes the table
    and folds every block of the launch as fold_grouped_q8_kernel does,
    reading and writing through the table's pointers."""

    def launch(table_ref, blocks, stream):
        t = ctypes.cast(table_ref, ctypes.POINTER(A._FoldQ8Table)).contents
        entries = [A.FoldEntry(k, t.leaf[k].leaf.tile0, t.leaf[k].leaf.tiles,
                               t.leaf[k].leaf.rows) for k in range(t.n)]
        coeff = _at(t.coeff, t.U * t.L, ctypes.c_float).view(t.U, t.L)
        tile = fold_tile(1)
        for b in range(blocks):
            k, row, ft = A.block_tile(entries, b)
            lf = t.leaf[k].leaf
            F, rows = lf.F, lf.rows
            assert lf.vec == int(F % 16 == 0 and lf.x % 16 == 0
                                 and lf.out % 16 == 0)
            x = _at(lf.x, t.U * rows * F, ctypes.c_int8).view(t.U, rows, F)
            out = _at(lf.out, rows * F, ctypes.c_float).view(rows, F)
            scale = _at(t.leaf[k].scales, t.U * rows, ctypes.c_float)
            lid = (int(_at(lf.ids, rows, ctypes.c_int32)[row]) if lf.ids
                   else lf.id0 + row)
            w = coeff[:, lid] * scale.view(t.U, rows)[:, row]
            f = slice(ft * tile, min(F, (ft + 1) * tile))
            out[row, f] = torch.einsum("u,uf->f", w,
                                       x[:, row, f].to(torch.float32))
        calls.append((t.n, blocks))
        return 0
    return launch


@pytest.mark.parametrize("n_leaves", [3, MAX_LEAVES_Q8 + 7])
def test_q8_tables_fold_every_leaf(monkeypatch, n_leaves):
    """The tables ``_fold_grouped`` fills for int8 leaves (pointers, layer
    ids as a range or a vector, scales, the vector flag), emulated block by
    block, give the plain fold; one launch per ``MAX_LEAVES_Q8`` leaves,
    each counted."""
    gen = torch.Generator().manual_seed(3)
    U, L = 4, 9
    spec = [(1 + k % 3, [1, 16, 300, 4097, 32, 4096][k % 6])
            for k in range(n_leaves)]
    qs = [torch.randint(-127, 128, (U, rows, F), generator=gen,
                        dtype=torch.int8) for rows, F in spec]
    scales = [torch.rand((U, rows), generator=gen) for rows, _ in spec]
    scales[0].zero_()                             # a zero-scale leaf
    ids = [k % L if rows == 1 else
           (torch.arange(k % 5, k % 5 + rows) if k % 2 else
            torch.randperm(L, generator=gen)[:rows])
           for k, (rows, _) in enumerate(spec)]
    c = torch.rand((U, L), generator=gen)
    c[1] = 0.0                                    # a zero-coefficient client

    class _Stream:
        cuda_stream = 0

    calls: list = []
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(A, "_grouped_kernel", lambda dtype: (
        _emulate_q8(calls), A._FoldQ8Table))
    before = adel_agg_q8_grouped.launches
    outs = A._fold_grouped(qs, ids, c, torch.float32, adel_agg_q8_grouped,
                           scales)
    launches = len(fold_plan([q.shape[1:] for q in qs], 1))
    assert launches == -(-n_leaves // MAX_LEAVES_Q8) == len(calls)
    assert adel_agg_q8_grouped.launches - before == launches
    refs = adel_agg_q8_grouped_plain(qs, scales, ids, c)
    for out, ref, q in zip(outs, refs, qs):
        assert out.shape == q.shape[1:] and out.dtype == torch.float32
        assert out.data_ptr() % 16 == 0
        np.testing.assert_allclose(out.numpy(), ref.numpy(), **TOL)
    assert torch.equal(outs[0], torch.zeros_like(outs[0]))
