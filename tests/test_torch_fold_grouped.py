"""The grouped Eq. 5 fold (``repro_torch.kernels.adel_agg.adel_agg_grouped``):
its block map, and the pytree folds that go through it against the
reference's Pallas path run in interpret mode.

The block map is the host side of the one launch a round: a prefix sum of
(rows x feature tiles) over the leaves of a table, and a binary search per
block (``block_tile``, the kernel's own search written in Python); at
itemsize 1 it is the int8 fold's (``adel_agg_q8_grouped``). On these
CPU tensors the fold computes its plain version (the CUDA kernel is held
against the same plain version on the card by ``chip_smoke.py`` and
``tests/test_torch_gpu.py``). Tolerances: f32 rtol 2e-5 / atol 1e-6, as the
existing pytree test; bf16 1e-2 (both round an f32 sum to bf16).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.aggregation import layer_coefficients as ref_layer_coefficients
from repro.kernels.ops import adel_aggregate_pallas
from repro_torch.core.aggregation import (aggregate_with_coeffs,
                                          layer_coefficients)
from repro_torch.kernels.adel_agg import (MAX_LEAVES, adel_agg_grouped,
                                          block_tile, fold_plan, fold_tile,
                                          table_leaves)
from repro_torch.kernels.ops import adel_aggregate

# every VGG-11 leaf at full width, in leaf order (whole-tensor leaves)
VGG11_F = [64, 64, 64, 1728, 128, 128, 128, 73728, 256, 256, 256, 294912,
           256, 256, 256, 589824, 512, 512, 512, 1179648, 512, 512, 512,
           2359296, 512, 512, 512, 2359296, 512, 512, 512, 2359296, 512,
           262144, 512, 262144, 10, 5120]

TABLES = {
    "vgg11": [(1, F) for F in VGG11_F],
    "more_than_a_table": [(1 + k % 3, [300, 7, 4096, 1000, 8, 2048][k % 6])
                          for k in range(2 * MAX_LEAVES + 9)],
    "ragged": [(3, 1), (1, 2049), (2, 4095), (5, 4097), (1, 10), (4, 0),
               (1, 8193)],
}


def _covered(dims, itemsize):
    """{(leaf, row, tile): times} over every block of every launch."""
    seen: dict = {}
    for entries, blocks in fold_plan(dims, itemsize):
        assert len(entries) <= table_leaves(itemsize) <= MAX_LEAVES
        assert blocks == sum(e.rows * e.tiles for e in entries)
        for b in range(blocks):
            key = block_tile(entries, b)
            seen[key] = seen.get(key, 0) + 1
    return seen


@pytest.mark.parametrize("table", sorted(TABLES))
@pytest.mark.parametrize("itemsize", [4, 2, 1])
def test_block_map_covers_every_tile_once(table, itemsize):
    """Every (leaf, layer row, feature tile) is folded by exactly one block,
    and no block falls outside a leaf."""
    dims = TABLES[table]
    tile = fold_tile(itemsize)
    want = {(i, row, t) for i, (rows, F) in enumerate(dims)
            for row in range(rows) for t in range(-(-F // tile))}
    seen = _covered(dims, itemsize)
    assert set(seen) == want
    assert set(seen.values()) == {1}


def test_block_map_launches_per_table():
    """One launch per MAX_LEAVES leaves; the largest leaves go first."""
    plan = fold_plan(TABLES["more_than_a_table"], 4)
    assert len(plan) == 3
    assert [len(e) for e, _ in plan] == [MAX_LEAVES, MAX_LEAVES, 9]
    # int8: 63 leaves a table; the plan is memoised (the same object)
    plan8 = fold_plan(TABLES["more_than_a_table"], 1)
    assert [len(e) for e, _ in plan8] == [63, 63, 11]
    assert fold_plan(TABLES["more_than_a_table"], 1) is plan8
    vgg = fold_plan(TABLES["vgg11"], 4)
    assert len(vgg) == 1
    entries, blocks = vgg[0]
    work = [e.rows * e.tiles for e in entries]
    assert work == sorted(work, reverse=True)
    assert [e.tile0 for e in entries] == [sum(work[:k]) for k in range(len(work))]
    # 9,756,426 f32 features in 2,048-wide tiles: the big leaves dominate
    assert blocks == sum(-(-F // fold_tile(4)) for F in VGG11_F)


def test_fold_tile_is_the_kernels():
    """threads x vectors x 16-byte vector, as csrc/adel_agg.cu has them;
    int8 leaves: one 16-code vector a thread, 63 leaves a table."""
    assert fold_tile(4) == 256 * 2 * 4
    assert fold_tile(2) == 256 * 2 * 8
    assert fold_tile(1) == 256 * 1 * 16
    assert (table_leaves(4), table_leaves(2), table_leaves(1)) == (64, 64, 63)


def _mixed_pytree(U, L, seed=0):
    """Stacked and whole-tensor leaves, f32 and bf16, F not a multiple of
    4 or 8."""
    rng = np.random.default_rng(seed)
    grads = {
        "blocks": {"w": rng.standard_normal((U, L, 6, 5)).astype(np.float32),
                   "b": rng.standard_normal((U, L, 3)).astype(np.float32)},
        "head": rng.standard_normal((U, 7, 9)).astype(np.float32),
        "embed": rng.standard_normal((U, 13)).astype(np.float32),
        "lo": rng.standard_normal((U, L, 11)).astype(np.float32),
    }
    ids = {"blocks": {"w": np.arange(L), "b": np.arange(L)},
           "head": L - 1, "embed": 0, "lo": np.arange(L)[::-1].copy()}
    bf16 = {"lo", "embed"}
    return grads, ids, bf16


def _torch_tree(grads, ids, bf16):
    tg = {k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()}
              if isinstance(v, dict) else
              torch.from_numpy(v).to(torch.bfloat16 if k in bf16
                                     else torch.float32))
          for k, v in grads.items()}
    ti = {k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()}
              if isinstance(v, dict) else
              (torch.from_numpy(v) if isinstance(v, np.ndarray) else int(v)))
          for k, v in ids.items()}
    return tg, ti


def _jax_tree(grads, ids, bf16):
    jg = {k: ({kk: jnp.asarray(vv) for kk, vv in v.items()}
              if isinstance(v, dict) else
              jnp.asarray(v, jnp.bfloat16 if k in bf16 else jnp.float32))
          for k, v in grads.items()}
    ji = {k: ({kk: jnp.asarray(vv) for kk, vv in v.items()}
              if isinstance(v, dict) else jnp.asarray(v))
          for k, v in ids.items()}
    return jg, ji


def _assert_tree_close(out, ref, bf16):
    for k in ref:
        if isinstance(ref[k], dict):
            _assert_tree_close(out[k], ref[k], ())
            continue
        tol = (dict(rtol=1e-2, atol=1e-2) if k in bf16
               else dict(rtol=2e-5, atol=1e-6))
        assert out[k].dtype == (torch.bfloat16 if k in bf16 else torch.float32)
        np.testing.assert_allclose(out[k].float().numpy(),
                                   np.asarray(ref[k], np.float32), **tol)


@pytest.mark.parametrize("bias_correct", [True, False])
def test_adel_aggregate_mixed_pytree_matches_pallas(bias_correct):
    """Stacked and scalar ids, f32 and bf16 leaves, ragged F: the port's
    pytree fold against ``adel_aggregate_pallas`` (interpret mode)."""
    U, L = 5, 4
    grads, ids, bf16 = _mixed_pytree(U, L)
    rng = np.random.default_rng(1)
    mask = (rng.uniform(size=(U, L)) > 0.35).astype(np.float32)
    p = np.full((L,), 0.1, np.float32)
    jg, ji = _jax_tree(grads, ids, bf16)
    ref = adel_aggregate_pallas(jg, ji, jnp.asarray(mask), jnp.asarray(p),
                                bias_correct=bias_correct, interpret=True)
    tg, ti = _torch_tree(grads, ids, bf16)
    out = adel_aggregate(tg, ti, torch.from_numpy(mask), torch.from_numpy(p),
                         bias_correct=bias_correct)
    _assert_tree_close(out, ref, bf16)


def test_coeffs_override_and_aggregate_with_coeffs_match_pallas():
    """The ``coeffs=`` override and ``aggregate_with_coeffs`` take explicit
    (U, L) coefficients (global cohort counts, as a chunked round has)."""
    U, L = 6, 3
    grads, ids, bf16 = _mixed_pytree(U, L, seed=2)
    rng = np.random.default_rng(3)
    mask = (rng.uniform(size=(U, L)) > 0.5).astype(np.float32)
    counts = mask.sum(0) + 2.0
    p = np.full((L,), 0.2, np.float32)
    c = np.asarray(ref_layer_coefficients(jnp.asarray(mask), jnp.asarray(p),
                                          counts=jnp.asarray(counts)))
    jg, ji = _jax_tree(grads, ids, bf16)
    ref = adel_aggregate_pallas(jg, ji, None, None, coeffs=jnp.asarray(c),
                                interpret=True)
    tg, ti = _torch_tree(grads, ids, bf16)
    tc = layer_coefficients(torch.from_numpy(mask), torch.from_numpy(p),
                            counts=torch.from_numpy(counts))
    np.testing.assert_allclose(tc.numpy(), c, rtol=1e-6, atol=0)
    _assert_tree_close(adel_aggregate(tg, ti, None, None, coeffs=tc), ref, bf16)
    _assert_tree_close(aggregate_with_coeffs(tg, ti, tc), ref, bf16)


def test_grouped_fold_on_cpu_is_plain_and_counts_nothing():
    """On CPU tensors the grouped entry computes each leaf's plain fold and
    launches nothing."""
    from repro_torch.kernels.adel_agg import adel_agg_grouped_plain
    gen = torch.Generator().manual_seed(0)
    leaves = [torch.randn((4, 1, 300), generator=gen),
              torch.randn((4, 3, 7), generator=gen)]
    ids = [2, torch.tensor([0, 2, 1])]
    c = torch.rand((4, 3), generator=gen)
    before = adel_agg_grouped.launches
    outs = adel_agg_grouped(leaves, ids, c)
    assert adel_agg_grouped.launches == before
    for out, ref in zip(outs, adel_agg_grouped_plain(leaves, ids, c)):
        assert torch.equal(out, ref)
    assert adel_agg_grouped([], [], c) == []
