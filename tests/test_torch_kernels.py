"""The port's Eq. 5 fold (``repro_torch.kernels``) against the reference's
Pallas kernels run in interpret mode, on the same numpy inputs.

On these CPU tensors the wrappers compute their plain PyTorch versions (the
CUDA kernels are held against the same plain versions on the card by
``chip_smoke.py`` and ``tests/test_torch_gpu.py``). Tolerances: f32
rtol = atol = 2e-5 (summation order); bf16 1e-2 (both round an f32 sum to
bf16, one ulp apart at most); int8 1e-2, as ``tests/test_kernels.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.aggregation import aggregate_grads
from repro.kernels.adel_agg import adel_agg as ref_adel_agg
from repro.kernels.adel_agg import adel_agg_q8 as ref_adel_agg_q8
from repro_torch.kernels.adel_agg import adel_agg, adel_agg_q8
from repro_torch.kernels.ops import adel_aggregate

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=1e-2, atol=1e-2)}


def _inputs(U, L, F, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((U, L, F)).astype(np.float32),
            rng.uniform(size=(U, L)).astype(np.float32))


def _quantize(g):
    """The wire's symmetric int8 absmax quantization of (U, L, F) deltas."""
    amax = np.abs(g).max(-1)
    inv = np.where(amax > 0, np.float32(127.0) / np.maximum(amax, 1e-30), 0.0)
    q = np.rint(g * inv[..., None].astype(np.float32)).astype(np.int8)
    return q, (amax / np.float32(127.0)).astype(np.float32)


@pytest.mark.parametrize("U,L,F,bf", [
    (4, 3, 512, 512),
    (16, 8, 1024, 256),
    (7, 5, 512, 128),
    (3, 2, 300, 128),     # F not a multiple of block_f
    (4, 3, 130, 512),     # F < block_f and odd
    (2, 2, 7, 4),         # tiny, non-multiple
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adel_agg_matches_pallas(U, L, F, bf, dtype):
    g, c = _inputs(U, L, F)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = ref_adel_agg(jnp.asarray(g, jdt), jnp.asarray(c, jdt), block_f=bf,
                       interpret=True)
    out = adel_agg(torch.from_numpy(g).to(tdt), torch.from_numpy(c).to(tdt))
    assert out.shape == (L, F) and out.dtype == tdt
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), **TOL[dtype])


@pytest.mark.parametrize("U,L,F,bf", [
    (4, 3, 512, 512),
    (7, 5, 300, 128),     # odd U, F not a multiple of block_f
    (3, 2, 130, 64),
    (2, 2, 7, 4),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adel_agg_q8_matches_pallas(U, L, F, bf, dtype):
    g, c = _inputs(U, L, F)
    q, scale = _quantize(g)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = ref_adel_agg_q8(jnp.asarray(q), jnp.asarray(scale, jdt),
                          jnp.asarray(c, jdt), block_f=bf, interpret=True)
    out = adel_agg_q8(torch.from_numpy(q), torch.from_numpy(scale).to(tdt),
                      torch.from_numpy(c).to(tdt))
    assert out.shape == (L, F) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-2,
                               atol=1e-2)


def test_adel_agg_q8_zero_coefficient_rows():
    """Clients with all-zero coefficients contribute nothing."""
    U, L, F = 6, 4, 96
    g, c = _inputs(U, L, F, seed=2)
    q, scale = _quantize(g)
    c[[1, 4]] = 0.0
    keep = [0, 2, 3, 5]
    out = adel_agg_q8(torch.from_numpy(q), torch.from_numpy(scale),
                      torch.from_numpy(c))
    ref = ref_adel_agg_q8(jnp.asarray(q[keep]), jnp.asarray(scale[keep]),
                          jnp.asarray(c[keep]), block_f=64, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_adel_agg_q8_zero_scale_layer():
    """An all-zero delta layer has scale 0 and folds to exactly zero."""
    U, L, F = 3, 2, 64
    g, _ = _inputs(U, L, F, seed=4)
    g[:, 1, :] = 0.0
    q, scale = _quantize(g)
    out = adel_agg_q8(torch.from_numpy(q), torch.from_numpy(scale),
                      torch.ones(U, L))
    assert torch.isfinite(out).all()
    assert torch.equal(out[1], torch.zeros(F))
    ref = ref_adel_agg_q8(jnp.asarray(q), jnp.asarray(scale), jnp.ones((U, L)),
                          block_f=64, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_adel_agg_q8_dequant_error_bound():
    """quantize -> fused fold stays within amax/254 per element times the
    summed coefficients of the dense fold."""
    U, L, F = 5, 3, 256
    g, c = _inputs(U, L, F, seed=5)
    q, scale = _quantize(g)
    out = adel_agg_q8(torch.from_numpy(q), torch.from_numpy(scale),
                      torch.from_numpy(c)).numpy()
    dense = adel_agg(torch.from_numpy(g), torch.from_numpy(c)).numpy()
    bound = (c * np.abs(g).max(-1) / 254.0).sum(0)
    assert np.all(np.abs(out - dense).max(-1) <= bound * 1.001)


def test_adel_aggregate_matches_reference_pytree():
    """Mixed stacked / whole-tensor layer ids, as the reference's
    ``aggregate_grads`` takes them."""
    U, L = 5, 4
    rng = np.random.default_rng(3)
    grads = {"a": rng.standard_normal((U, L, 24, 8)).astype(np.float32),
             "b": rng.standard_normal((U, 10)).astype(np.float32)}
    mask = (rng.uniform(size=(U, L)) > 0.4).astype(np.float32)
    p = np.full((L,), 0.08, np.float32)
    ref = aggregate_grads({k: jnp.asarray(v) for k, v in grads.items()},
                          {"a": jnp.arange(L), "b": jnp.int32(1)},
                          jnp.asarray(mask), jnp.asarray(p))
    out = adel_aggregate({k: torch.from_numpy(v) for k, v in grads.items()},
                         {"a": torch.arange(L), "b": 1},
                         torch.from_numpy(mask), torch.from_numpy(p))
    for k in grads:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=2e-5, atol=1e-6)
    # the coeffs= override gives the same fold
    from repro_torch.core.aggregation import layer_coefficients
    c = layer_coefficients(torch.from_numpy(mask), torch.from_numpy(p))
    out2 = adel_aggregate({k: torch.from_numpy(v) for k, v in grads.items()},
                          {"a": torch.arange(L), "b": 1}, None, None,
                          coeffs=c)
    for k in grads:
        assert torch.equal(out[k], out2[k])
