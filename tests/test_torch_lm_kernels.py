"""The port's LM kernels (``repro_torch.kernels.flash_attention`` and
``.ssd_scan``, with their model-layout wrappers in ``kernels/ops.py``)
against the reference's Pallas kernels run in interpret mode, on the same
numpy inputs, at the sweep of ``tests/test_kernels.py``.

On these CPU tensors the wrappers compute their plain PyTorch versions (the
CUDA kernels are held against the same plain versions on the card by
``chip_smoke.py`` and ``tests/test_torch_gpu.py``). Tolerances, as the
reference's own kernel tests: flash f32 rtol = atol = 2e-5 (summation
order), bf16 3e-2 (both round an f32 result to bf16; the Pallas kernel
rounds its bf16 inputs' products in another order); SSD 3e-4 (the chunked
sums against the sequential scan, in f32).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as ref_flash
from repro.kernels.ops import gqa_flash as ref_gqa_flash
from repro.kernels.ops import ssd_chunked_pallas
from repro.kernels.ssd_scan import ssd_scan as ref_ssd_scan
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain,
                                                 visible_pairs)
from repro_torch.kernels.ops import gqa_flash, ssd_chunked_kernel
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}
SSD_TOL = dict(rtol=3e-4, atol=3e-4)


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _softplus(x):
    return np.log1p(np.exp(x)).astype(np.float32)


def _both(a: np.ndarray, dtype: str):
    return jnp.asarray(a, getattr(jnp, dtype)), torch.from_numpy(a).to(
        getattr(torch, dtype))


def _close(out: torch.Tensor, ref, tol) -> None:
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               **tol)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

def _qkv(B, H, KV, Sq, Sk, hd, dtype, seed=0):
    return [_both(_normal(shape, seed + i), dtype) for i, shape in
            enumerate([(B, H, Sq, hd), (B, KV, Sk, hd), (B, KV, Sk, hd)])]


@pytest.mark.parametrize("B,H,KV,S,hd", [
    (1, 2, 2, 128, 64),      # MHA
    (2, 4, 2, 256, 64),      # GQA g=2
    (1, 8, 1, 128, 128),     # MQA
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_pallas(B, H, KV, S, hd, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(B, H, KV, S, S, hd, dtype)
    ref = ref_flash(jq, jk, jv, causal=True, block_q=64, block_k=64,
                    interpret=True)
    out = flash_attention(tq, tk, tv, causal=True)
    assert out.shape == (B, H, S, hd) and out.dtype == tq.dtype
    _close(out, ref, TOL[dtype])


@pytest.mark.parametrize("window", [32, 64, 100])
def test_flash_attention_window_matches_pallas(window):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(1, 2, 1, 256, 256, 64, "float32")
    ref = ref_flash(jq, jk, jv, causal=True, window=window, block_q=64,
                    block_k=64, interpret=True)
    _close(flash_attention(tq, tk, tv, causal=True, window=window), ref,
           TOL["float32"])


def test_flash_noncausal_cross_shapes_match_pallas():
    """Sq != Sk (cross-attention shape)."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(2, 2, 2, 128, 256, 64, "float32")
    ref = ref_flash(jq, jk, jv, causal=False, block_q=64, block_k=64,
                    interpret=True)
    _close(flash_attention(tq, tk, tv, causal=False), ref, TOL["float32"])


def test_gqa_flash_model_layout_matches_pallas():
    B, S, H, KV, hd = 2, 128, 4, 2, 64
    (jq, tq), (jk, tk), (jv, tv) = [
        _both(_normal(shape, 3 + i), "float32") for i, shape in
        enumerate([(B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)])]
    ref = ref_gqa_flash(jq, jk, jv, block_q=64, block_k=64, interpret=True)
    out = gqa_flash(tq, tk, tv)
    assert out.shape == (B, S, H, hd)
    _close(out, ref, TOL["float32"])


def test_flash_ragged_and_empty_rows():
    """The port takes any Sq and Sk (the Pallas kernel asserts Sq % bq == 0):
    a ragged length agrees with the reference at the padded length's first
    rows, and a query that sees no key (Sq > Sk with a window) gives 0."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(1, 4, 2, 128, 128, 64, "float32")
    ref = ref_flash(jq, jk, jv, causal=True, window=48, block_q=64,
                    block_k=64, interpret=True)
    out = flash_attention(tq[:, :, :100].contiguous(),
                          tk[:, :, :100].contiguous(),
                          tv[:, :, :100].contiguous(), causal=True, window=48)
    _close(out, np.asarray(ref)[:, :, :100], TOL["float32"])
    out = flash_attention(tq, tk[:, :, :40].contiguous(),
                          tv[:, :, :40].contiguous(), causal=True, window=16)
    assert torch.isfinite(out).all()
    assert (out[:, :, 40 + 15:] == 0).all() and (out[:, :, :40] != 0).any()


def test_visible_pairs_counts_the_mask():
    for Sq, Sk, causal, window in [(100, 100, True, 0), (128, 256, False, 0),
                                   (300, 300, True, 64), (50, 20, True, 8)]:
        mask = np.ones((Sq, Sk), bool)
        i, j = np.arange(Sq)[:, None], np.arange(Sk)[None, :]
        if causal:
            mask &= j <= i
        if window:
            mask &= j > i - window
        assert visible_pairs(Sq, Sk, causal=causal, window=window) == mask.sum()


def test_flash_plain_is_the_wrapper_on_cpu():
    (_, tq), (_, tk), (_, tv) = _qkv(1, 4, 2, 64, 64, 64, "float32")
    before = flash_attention.launches
    assert torch.equal(flash_attention(tq, tk, tv, window=32),
                       flash_attention_plain(tq, tk, tv, window=32))
    assert flash_attention.launches == before


# ---------------------------------------------------------------------------
# SSD scan
# ---------------------------------------------------------------------------

def _ssd_inputs(B, S, H, P, N, seed=0):
    x = _normal((B, S, H, P), seed)
    dt = _softplus(_normal((B, S, H), seed + 1))
    A = _softplus(_normal((H,), seed + 2))
    b = 0.3 * _normal((B, S, N), seed + 3)
    c = 0.3 * _normal((B, S, N), seed + 4)
    return x, dt, A, b, c


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (1, 64, 2, 16, 8, 16),
    (2, 128, 4, 32, 16, 32),
    (1, 256, 1, 64, 128, 64),     # mamba2-370m block dims
    (2, 128, 3, 50, 16, 64),      # hymba-1.5b's P = 50
])
def test_ssd_chunked_kernel_matches_pallas(B, S, H, P, N, chunk):
    arrays = _ssd_inputs(B, S, H, P, N)
    ref = ssd_chunked_pallas(*map(jnp.asarray, arrays), chunk=chunk,
                             interpret=True)
    out = ssd_chunked_kernel(*_t(*arrays), chunk=chunk)
    assert out.shape == (B, S, H, P) and out.dtype == torch.float32
    _close(out, ref, SSD_TOL)


@pytest.mark.parametrize("per_batch", [True, False])
def test_ssd_scan_matches_pallas_in_kernel_layout(per_batch):
    """The kernel layout: b, c per batch (G = B, what the model passes) or
    per head (G = BH, the reference's copies) give the reference's y."""
    B, S, H, P, N, chunk = 2, 128, 3, 16, 8, 32
    x, dt, A, b, c = _ssd_inputs(B, S, H, P, N, seed=5)
    xdt = (x * dt[..., None]).transpose(0, 2, 1, 3).reshape(B * H, S, P)
    la = (-A[None, None] * dt).transpose(0, 2, 1).reshape(B * H, S)
    bh = np.broadcast_to(b[:, None], (B, H, S, N)).reshape(B * H, S, N)
    ch = np.broadcast_to(c[:, None], (B, H, S, N)).reshape(B * H, S, N)
    ref = ref_ssd_scan(*map(jnp.asarray, (xdt, la, bh, ch)), chunk=chunk,
                       interpret=True)
    bb, cc = (b, c) if per_batch else (np.ascontiguousarray(bh),
                                       np.ascontiguousarray(ch))
    out = ssd_scan(*_t(np.ascontiguousarray(xdt), np.ascontiguousarray(la),
                       bb, cc), chunk=chunk)
    _close(out, ref, SSD_TOL)


def test_ssd_scan_state_carry_vs_chunking():
    """Chunk size must not change the result (state carried correctly)."""
    arrays = _t(*_ssd_inputs(1, 128, 2, 16, 8))
    o1 = ssd_chunked_kernel(*arrays, chunk=16)
    o2 = ssd_chunked_kernel(*arrays, chunk=128)
    np.testing.assert_allclose(o1.numpy(), o2.numpy(), **SSD_TOL)


def test_ssd_plain_is_the_wrapper_on_cpu():
    x = torch.randn(4, 64, 16, generator=torch.Generator().manual_seed(0))
    la = -torch.rand(4, 64, generator=torch.Generator().manual_seed(1))
    b = torch.randn(2, 64, 8, generator=torch.Generator().manual_seed(2))
    before = ssd_scan.launches
    assert torch.equal(ssd_scan(x, la, b, b, chunk=16),
                       ssd_scan_plain(x, la, b, b, chunk=16))
    assert ssd_scan.launches == before
