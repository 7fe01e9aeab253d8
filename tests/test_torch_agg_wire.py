"""The Eq. 5 fold and the wire format in the port, against the reference on
the same numpy inputs: the ports of ``tests/test_aggregation.py`` (without
its ``shard_map`` case, which ``tests/test_torch_shard_map.py`` ports over
real ranks) and of ``tests/test_compression.py`` (without its Pallas
cases, which ``tests/test_torch_fold_q8.py`` covers through the port's
grouped int8 kernel).

Tolerances: folds rtol 2e-5 / atol 1e-6, as the reference's own tests
(f32 sums in another order); coefficients rtol 1e-6 (the same f32
divisions); int8 payloads exactly equal (the same absmax, the same
``127 / amax`` and round-half-even in both packages); the fused
aggregation against the dense fold atol 0.05, as the reference's test
(int8 rounding); byte counts exactly equal (analytic).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.core import aggregation as ra
from repro.core import compression as rcmp
from repro_torch.core.aggregation import (aggregate_grads, layer_coefficients,
                                          masked_mean_grads)
from repro_torch.core.compression import (CompressionConfig,
                                          aggregate_compressed,
                                          compress_deltas, make_compression,
                                          payload_bytes)
from repro_torch.tree import tree_map

U, L = 6, 4


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _fold_both(g, mask, p, **kw):
    """(port, reference) Eq. 5 folds of one stacked-layer leaf."""
    Lg = g.shape[1]
    ours = aggregate_grads({"w": _t(g)}, {"w": torch.arange(Lg)}, _t(mask),
                           _t(p), **kw)["w"].numpy()
    ref = np.asarray(ra.aggregate_grads({"w": jnp.asarray(g)},
                                        {"w": jnp.arange(Lg)},
                                        jnp.asarray(mask), jnp.asarray(p),
                                        **kw)["w"])
    return ours, ref


# ---------------------------------------------------------------------------
# test_aggregation
# ---------------------------------------------------------------------------

@settings(deadline=None, max_examples=30)
@given(st.integers(2, 9), st.integers(1, 7), st.integers(1, 5),
       st.integers(0, 2 ** 30))
def test_full_mask_recovers_fedavg(Uc, Lc, F, seed):
    """With everyone contributing and p = 0, Eq. 5 is exactly FedAvg."""
    g = np.random.default_rng(seed).normal(size=(Uc, Lc, F)).astype(
        np.float32)
    ours, ref = _fold_both(g, np.ones((Uc, Lc), np.float32),
                           np.zeros(Lc, np.float32))
    np.testing.assert_allclose(ours, g.mean(0), rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(ours, ref, rtol=2e-5, atol=1e-6)


@settings(deadline=None, max_examples=30)
@given(st.integers(2, 8), st.integers(2, 6), st.integers(0, 2 ** 30),
       st.floats(0.0, 0.19))
def test_scale_equivariance(Uc, Lc, seed, p_val):
    """agg(c g) = c agg(g): the fold is linear in the gradients."""
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(Uc, Lc, 3)).astype(np.float32)
    mask = (rng.random((Uc, Lc)) > 0.4).astype(np.float32)
    p = np.full((Lc,), p_val, np.float32)
    a1, r1 = _fold_both(2.5 * g, mask, p)
    a2, _ = _fold_both(g, mask, p)
    np.testing.assert_allclose(a1, 2.5 * a2, rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(a1, r1, rtol=2e-5, atol=1e-6)


def test_empty_layer_zero_and_correction():
    g = np.ones((5, 4, 2), np.float32)
    mask = np.ones((5, 4), np.float32)
    mask[:, 2] = 0.0
    p = np.asarray([0.0, 0.1, 0.5, 0.19], np.float32)
    ours, ref = _fold_both(g, mask, p)
    np.testing.assert_allclose(ours[2], 0.0)
    np.testing.assert_allclose(ours[1], 1 / 0.9, rtol=1e-6)
    np.testing.assert_allclose(ours, ref, rtol=1e-6)


def test_masked_mean_no_correction():
    g = torch.ones((4, 3, 2))
    out = masked_mean_grads({"w": g}, {"w": torch.arange(3)},
                            torch.ones((4, 3)))["w"]
    np.testing.assert_allclose(out.numpy(), 1.0, rtol=1e-6)
    ref = ra.masked_mean_grads({"w": jnp.ones((4, 3, 2))},
                               {"w": jnp.arange(3)}, jnp.ones((4, 3)))["w"]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6)


@settings(deadline=None, max_examples=25)
@given(st.integers(2, 8), st.integers(2, 6), st.integers(0, 2 ** 30))
def test_coefficients_rowsum(Uc, Lc, seed):
    """For layers with contributors the coefficients sum to 1/(1-p_l);
    empty layers sum to 0 (update preserved); equal to the reference's."""
    rng = np.random.default_rng(seed)
    mask = (rng.random((Uc, Lc)) > 0.5).astype(np.float32)
    p = rng.uniform(0, 0.19, Lc).astype(np.float32)
    c = layer_coefficients(_t(mask), _t(p)).numpy()
    counts = mask.sum(0)
    expect = np.where(counts > 0, 1.0 / (1.0 - p), 0.0)
    np.testing.assert_allclose(c.sum(0), expect, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        c, np.asarray(ra.layer_coefficients(jnp.asarray(mask),
                                            jnp.asarray(p))), rtol=1e-6)


# ---------------------------------------------------------------------------
# test_compression
# ---------------------------------------------------------------------------

def _tree(seed=0):
    """A stacked delta pytree like the backends produce, as numpy: one
    stacked-layer leaf, one whole-tensor (scalar-id) leaf."""
    rng = np.random.default_rng(seed)
    grads = {"w": rng.standard_normal((U, L, 24, 8)).astype(np.float32),
             "head": rng.standard_normal((U, 10)).astype(np.float32)}
    params = {"w": np.zeros((L, 24, 8), np.float32),
              "head": np.zeros((10,), np.float32)}
    return grads, params


def _port(tree):
    return tree_map(_t, tree)


def _ids():
    return ({"w": torch.arange(L), "head": L - 1},
            {"w": jnp.arange(L), "head": jnp.int32(L - 1)})


def _mask_p(seed=1):
    rng = np.random.default_rng(seed)
    return ((rng.random((U, L)) > 0.3).astype(np.float32),
            np.full((L,), 0.08, np.float32))


def test_make_compression_specs():
    assert make_compression(None).mode == "none"
    assert make_compression("int8").mode == "int8"
    cfg = make_compression(("topk8", 0.1))
    assert cfg.mode == "topk8" and cfg.top_k == 0.1
    assert make_compression(cfg) is cfg
    with pytest.raises(AssertionError):
        make_compression("zstd")
    with pytest.raises(AssertionError):
        CompressionConfig(mode="topk8", top_k=0.0)


def test_wire_scale():
    for spec in (None, "int8", ("topk8", 0.05)):
        assert make_compression(spec).wire_scale() == pytest.approx(
            rcmp.make_compression(spec).wire_scale())
    assert make_compression("int8").wire_scale() == 0.25


def test_int8_payload_layout_roundtrip_and_reference():
    grads, _ = _tree()
    ids, rids = _ids()
    payload = compress_deltas(_port(grads), ids, make_compression("int8"))
    assert len(payload) == 2          # jax.tree order: head then w
    (q_h, s_h), (q_w, s_w) = payload
    assert q_h.dtype == torch.int8 and tuple(q_h.shape) == (U, 1, 10)
    assert s_h.dtype == torch.float32 and tuple(s_h.shape) == (U, 1)
    assert tuple(q_w.shape) == (U, L, 24 * 8) and tuple(s_w.shape) == (U, L)
    flat = grads["w"].reshape(U, L, -1)
    deq = q_w.numpy().astype(np.float32) * s_w.numpy()[..., None]
    amax = np.abs(flat).max(-1, keepdims=True)
    assert np.all(np.abs(deq - flat) <= amax / 254.0 + 1e-7)
    ref = rcmp.compress_deltas(jax.tree.map(jnp.asarray, grads), rids,
                               rcmp.make_compression("int8"))
    for (q, s), (rq, rs) in zip(payload, ref):
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(rs))


def test_topk8_payload_keeps_largest_magnitudes():
    grads, _ = _tree()
    ids, _ = _ids()
    q_w, s_w, idx_w = compress_deltas(_port(grads), ids,
                                      make_compression(("topk8", 0.25)))[1]
    k = int(np.ceil(0.25 * 24 * 8))
    assert tuple(q_w.shape) == (U, L, k) and idx_w.dtype == torch.int32
    flat = np.abs(grads["w"].reshape(U, L, -1))
    idx = idx_w.numpy().astype(np.int64)
    kept = np.take_along_axis(flat, idx, axis=-1)
    dropped = np.ones_like(flat, bool)
    np.put_along_axis(dropped, idx, False, axis=-1)
    assert np.all(np.where(dropped, flat, 0.0)
                  <= kept.min(-1)[..., None] + 1e-7)


def test_int8_aggregate_close_to_dense_and_reference():
    grads, params = _tree()
    ids, rids = _ids()
    mask, p = _mask_p()
    cfg = make_compression("int8")
    out = aggregate_compressed(compress_deltas(_port(grads), ids, cfg),
                               _port(params), ids, _t(mask), _t(p), cfg=cfg)
    dense = aggregate_grads(_port(grads), ids, _t(mask), _t(p))
    rcfg = rcmp.make_compression("int8")
    rgrads = jax.tree.map(jnp.asarray, grads)
    ref = rcmp.aggregate_compressed(
        rcmp.compress_deltas(rgrads, rids, rcfg),
        jax.tree.map(jnp.asarray, params), rids, jnp.asarray(mask),
        jnp.asarray(p), cfg=rcfg, agg_impl="jnp")
    for key in params:
        np.testing.assert_allclose(out[key].numpy(), dense[key].numpy(),
                                   atol=0.05)
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   rtol=2e-5, atol=1e-6)


def test_topk_full_fraction_matches_int8():
    """top_k = 1.0 keeps every entry: the scatter-add path reproduces the
    int8 fold."""
    grads, params = _tree(seed=2)
    ids, _ = _ids()
    mask, p = _mask_p(seed=3)
    q8, tk = make_compression("int8"), make_compression(("topk8", 1.0))
    a = aggregate_compressed(compress_deltas(_port(grads), ids, q8),
                             _port(params), ids, _t(mask), _t(p), cfg=q8)
    b = aggregate_compressed(compress_deltas(_port(grads), ids, tk),
                             _port(params), ids, _t(mask), _t(p), cfg=tk)
    for key in params:
        np.testing.assert_allclose(a[key].numpy(), b[key].numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_coeffs_override_matches_mask_path():
    """Per-client folds with explicit coefficient rows (the temporal
    backend's) sum to the one-shot fold."""
    grads, params = _tree(seed=4)
    ids, _ = _ids()
    mask, p = _mask_p(seed=5)
    cfg = make_compression("int8")
    tgrads = _port(grads)
    coeffs = layer_coefficients(_t(mask), _t(p))
    whole = aggregate_compressed(compress_deltas(tgrads, ids, cfg),
                                 _port(params), ids, _t(mask), _t(p), cfg=cfg)
    acc = None
    for u in range(U):
        g1 = tree_map(lambda g: g[u:u + 1], tgrads)
        part = aggregate_compressed(compress_deltas(g1, ids, cfg),
                                    _port(params), ids, None, None, cfg=cfg,
                                    coeffs=coeffs[u:u + 1])
        acc = part if acc is None else tree_map(torch.add, acc, part)
    for key in params:
        np.testing.assert_allclose(acc[key].numpy(), whole[key].numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_payload_bytes_analytic():
    _, params = _tree()
    ids, rids = _ids()
    n_el = L * 24 * 8 + 10
    tp, jp = _port(params), jax.tree.map(jnp.asarray, params)
    for spec in (None, "int8", ("topk8", 0.05)):
        ours = payload_bytes(tp, ids, U, make_compression(spec))
        assert ours == tuple(rcmp.payload_bytes(jp, rids, U,
                                                rcmp.make_compression(spec)))
    logical, wire = payload_bytes(tp, ids, U, make_compression(None))
    assert logical == wire == 4 * n_el * U
    logical, wire = payload_bytes(tp, ids, U, make_compression("int8"))
    assert wire == (n_el + 4 * (L + 1)) * U
    k_w, k_h = int(np.ceil(0.05 * 192)), max(1, int(np.ceil(0.05 * 10)))
    _, wire = payload_bytes(tp, ids, U, make_compression(("topk8", 0.05)))
    assert wire == (5 * (L * k_w + k_h) + 4 * (L + 1)) * U
    assert logical / payload_bytes(tp, ids, U,
                                   make_compression("int8"))[1] > 3.5
