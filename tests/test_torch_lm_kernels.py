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
import math

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
                                                 kernel_strides, visible_mask,
                                                 visible_pairs)
from repro_torch.kernels.ops import gqa_flash, ssd_chunked_kernel
from repro_torch.kernels.ssd_scan import scan_strides, ssd_scan, ssd_scan_plain

from _ssd_tc import emulate_tc_scan

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
# the bf16 tensor-core kernel's arithmetic, emulated on the CPU
# ---------------------------------------------------------------------------
# ``csrc/flash_attention.cu:flash_fwd_kernel_tc`` runs only on the card. Its
# schedule is repeated here in f32: 128-row q blocks of two 64-row
# warpgroups, the KV loop from the window's first tile to the causal
# frontier, tiles no row of a warpgroup sees skipped, the mask applied only
# where the kernel applies it, keys past Sk zero (TMA's fill), the online
# softmax with exp2 and the scale folded in, P split into bf16 hi + lo, f32
# accumulation. It is held against the plain version at the card's bf16
# check (rtol 1e-2, atol 1e-3: one bf16 ulp, the tolerance
# ``chip_smoke.py`` and ``tests/test_torch_gpu.py`` hold the kernel to).
CARD_BF16_TOL = dict(rtol=1e-2, atol=1e-3)


def _emulate_tc_kernel(q, k, v, *, causal, window, bk=128):
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    c = hd ** -0.5 * math.log2(math.e)
    pad = -(-Sk // bk) * bk - Sk
    kk = torch.nn.functional.pad(k.float(), (0, 0, 0, pad)).repeat_interleave(G, 1)
    vv = torch.nn.functional.pad(v.float(), (0, 0, 0, pad)).repeat_interleave(G, 1)
    qf = q.float()
    out = torch.zeros((B, H, Sq, hd))
    for q0 in range(0, Sq, 128):
        q_last = min(q0 + 128, Sq) - 1
        k_lo = max(0, q0 - window + 1) if window else 0
        k_hi = min(Sk, q_last + 1) if causal else Sk
        t_lo = k_lo // bk
        n_tiles = max(0, -(-k_hi // bk) - t_lo)
        for r_lo in range(q0, min(q0 + 128, Sq), 64):
            r_hi = r_lo + 63
            rows = torch.arange(r_lo, min(r_hi + 1, Sq))
            m = torch.full((B, H, len(rows)), -math.inf)
            l = torch.zeros((B, H, len(rows)))
            acc = torch.zeros((B, H, len(rows), hd))
            for it in range(n_tiles):
                kt = (t_lo + it) * bk
                if (causal and kt > r_hi) or (window and kt + bk - 1 <= r_lo - window):
                    continue
                s = qf[:, :, rows] @ kk[:, :, kt:kt + bk].transpose(-1, -2)
                if ((kt + bk > Sk) or (causal and kt + bk - 1 > r_lo)
                        or (window and kt <= r_hi - window)):
                    keys = torch.arange(kt, kt + bk)
                    vis = (keys[None] < Sk).expand(len(rows), bk)
                    if causal:
                        vis = vis & (keys[None] <= rows[:, None])
                    if window:
                        vis = vis & (keys[None] > rows[:, None] - window)
                    s = s.masked_fill(~vis, -math.inf)
                m_new = torch.maximum(m, s.amax(-1) * c)
                m_use = torch.where(m_new == -math.inf, 0.0, m_new)
                alpha = torch.exp2(m - m_use)
                p = torch.exp2(s * c - m_use[..., None])
                l = l * alpha + p.sum(-1)
                hi = p.to(torch.bfloat16).float()
                lo = (p - hi).to(torch.bfloat16).float()
                vt = vv[:, :, kt:kt + bk]
                acc = acc * alpha[..., None] + hi @ vt + lo @ vt
                m = m_new
            out[:, :, rows] = acc / l.clamp_min(1e-30)[..., None]
    return out.to(q.dtype)


@pytest.mark.parametrize("B,H,KV,Sq,Sk,hd,causal,window", [
    (1, 25, 5, 1024, 1024, 64, True, 256),    # hymba's heads, a window
    (1, 32, 4, 512, 512, 128, True, 0),       # yi-6b's heads, causal
    (1, 2, 1, 200, 200, 64, True, 1),         # every row sees one key
    (1, 2, 1, 200, 200, 128, True, 2),        # ... or two
    (2, 2, 2, 130, 300, 64, False, 0),        # cross, ragged Sq and Sk
    (1, 2, 1, 200, 40, 64, True, 16),         # rows that see no key
    (1, 2, 1, 300, 400, 128, False, 50),      # a window, not causal
])
def test_tensor_core_schedule_matches_plain_at_card_tolerance(
        B, H, KV, Sq, Sk, hd, causal, window):
    (_, tq), (_, tk), (_, tv) = _qkv(B, H, KV, Sq, Sk, hd, "bfloat16", seed=7)
    ref = flash_attention_plain(tq, tk, tv, causal=causal, window=window)
    out = _emulate_tc_kernel(tq, tk, tv, causal=causal, window=window)
    _close(out, ref.float(), CARD_BF16_TOL)
    if Sq > Sk:
        assert (out[:, :, Sk + window - 1:] == 0).all()


def test_emulated_schedule_visits_every_visible_pair():
    """The emulation's tile range and skips, as a count: every visible
    (row, key) pair lies in a tile the kernel's loop computes."""
    for Sq, Sk, causal, window in [(1000, 1000, True, 100), (4096, 4096, True, 1024),
                                   (130, 300, False, 0), (200, 40, True, 16),
                                   (2048, 2048, True, 0), (300, 400, False, 50)]:
        seen = torch.zeros((Sq, Sk), dtype=torch.bool)
        for q0 in range(0, Sq, 128):
            q_last = min(q0 + 128, Sq) - 1
            k_lo = max(0, q0 - window + 1) if window else 0
            k_hi = min(Sk, q_last + 1) if causal else Sk
            for kt in range((k_lo // 128) * 128, k_hi, 128):
                for r_lo in (q0, q0 + 64):
                    if not ((causal and kt > r_lo + 63)
                            or (window and kt + 127 <= r_lo - window)):
                        seen[r_lo:r_lo + 64, kt:kt + 128] = True
        assert not (visible_mask(Sq, Sk, causal, window) & ~seen).any()


# ---------------------------------------------------------------------------
# the kernels' stride rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_strides_take_both_layouts(dtype):
    """The kernels read (B, H, S, hd) tensors and (B, H, S, hd) views of the
    model's (B, S, H, hd) tensors, with no copy; a size-1 dim's stride is
    never stepped over and is replaced."""
    B, S, H, hd = 2, 100, 25, 64
    bshd = torch.zeros((B, S, H, hd), dtype=dtype)
    assert kernel_strides(bshd.transpose(1, 2)) == (S * H * hd, hd, H * hd)
    bhsd = torch.zeros((B, H, S, hd), dtype=dtype)
    assert kernel_strides(bhsd) == (H * S * hd, S * hd, hd)
    one = torch.zeros((1, S, 1, 128), dtype=dtype).transpose(1, 2)
    assert kernel_strides(one) == (128, 128, 128)
    # a head slice of a wider row keeps 16-byte aligned strides
    wide = torch.zeros((B, S, H, 2 * hd), dtype=dtype)[..., :hd]
    assert kernel_strides(wide.transpose(1, 2)) == (S * H * 2 * hd, 2 * hd,
                                                   H * 2 * hd)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_strides_refuse_what_the_kernels_cannot_read(dtype):
    B, S, H, hd = 2, 100, 4, 64
    x = torch.zeros((B, S, H, hd + 4), dtype=dtype)
    with pytest.raises(ValueError, match="unit stride"):
        kernel_strides(torch.zeros((B, H, hd, S), dtype=dtype).transpose(2, 3))
    if dtype == torch.bfloat16:      # rows of hd + 4 bf16: 136 bytes
        with pytest.raises(ValueError, match="16 bytes"):
            kernel_strides(x[..., :hd].transpose(1, 2))
    flat = torch.zeros(B * H * S * hd + 1, dtype=dtype)
    with pytest.raises(ValueError, match="aligned"):
        kernel_strides(flat[1:].view(B, H, S, hd))
    with pytest.raises(ValueError, match="16 bytes"):
        kernel_strides(torch.zeros((1, H, S, hd), dtype=dtype).expand(B, H, S, hd))


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


# ---------------------------------------------------------------------------
# the tensor-core chunk scan, in the card kernel's order and rounding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("G,r,S,P,N,Q", [
    (1, 2, 64, 16, 8, 64),       # one chunk
    (2, 3, 256, 16, 8, 32),      # many chunks, r > 1 heads a group
    (2, 4, 256, 50, 16, 64),     # hymba-1.5b's P and N
    (1, 2, 128, 64, 128, 64),    # mamba2-370m's P and N, narrowed
    (3, 1, 96, 7, 5, 16),        # per-head b, c (G = BH), odd widths
])
def test_tensor_core_scan_matches_pallas(G, r, S, P, N, Q):
    """The kernel's one pass (64-token tiles walked in order, the state
    carried from tile to tile, every product as three TF32 products:
    ``tests/_ssd_tc.py``) against the reference's Pallas kernel, which
    carries the state through a sequential chunk loop."""
    rng = np.random.default_rng(G * 100 + P)
    xdt = rng.standard_normal((G, r, S, P)).astype(np.float32)
    la = -rng.uniform(size=(G, r, S)).astype(np.float32)
    b = (0.3 * rng.standard_normal((G, S, N))).astype(np.float32)
    c = (0.3 * rng.standard_normal((G, S, N))).astype(np.float32)
    bh = np.broadcast_to(b[:, None], (G, r, S, N)).reshape(G * r, S, N)
    ch = np.broadcast_to(c[:, None], (G, r, S, N)).reshape(G * r, S, N)
    ref = ref_ssd_scan(jnp.asarray(xdt.reshape(G * r, S, P)),
                       jnp.asarray(la.reshape(G * r, S)), jnp.asarray(bh),
                       jnp.asarray(ch), chunk=Q, interpret=True)
    out = emulate_tc_scan(*_t(xdt, la, b, c))
    _close(out.reshape(G * r, S, P), ref, SSD_TOL)


@pytest.mark.parametrize("B,S,H,P", [(2, 128, 3, 50), (1, 64, 1, 7)])
def test_scan_strides_read_the_model_layout(B, S, H, P):
    """The kernels step through (group, head, token) with P unit-stride:
    (B, H, S, P) views of the model's (B, S, H, P) tensors and (B, H, S)
    views of its (B, S, H) tensors, contiguous 4-D (G, r, S, P) and 3-D
    (BH, S, P) inputs, whose BH splits into G groups of r heads."""
    x = torch.zeros((B, S, H, P))
    assert scan_strides(x.transpose(1, 2), B, features=True) == (
        S * H * P, P, H * P)
    la = torch.zeros((B, S, H))
    assert scan_strides(la.transpose(1, 2), B, features=False) == (S * H, 1, H)
    flat = torch.zeros((B * H, S, P))
    assert scan_strides(flat, B, features=True) == (H * S * P, S * P, P)
    assert scan_strides(flat.view(B, H, S, P), B, features=True) == (
        H * S * P, S * P, P)
    assert scan_strides(torch.zeros((B * H, S)), B, features=False) == (
        H * S, S, 1)
    with pytest.raises(ValueError, match="unit stride"):
        scan_strides(torch.zeros((B, H, P, S)).transpose(2, 3), B,
                     features=True)
    with pytest.raises(ValueError):
        scan_strides(torch.zeros((S, P)), 1, features=True)


def test_ssd_scan_model_layout_views_equal_contiguous():
    """(B, H, S, P) views of model-layout tensors and their contiguous
    copies give equal y, in xdt's shape, through ``ssd_scan`` and through
    ``ssd_chunked_kernel``'s (B, S, H, P) result."""
    B, S, H, P, N, chunk = 2, 128, 3, 50, 16, 32
    x, dt, A, b, c = _ssd_inputs(B, S, H, P, N, seed=7)
    xdt = torch.from_numpy(x * dt[..., None])
    la = torch.from_numpy(-A[None, None] * dt)
    bt, ct = _t(b, c)
    view = ssd_scan(xdt.transpose(1, 2), la.transpose(1, 2), bt, ct,
                    chunk=chunk)
    flat = ssd_scan(xdt.transpose(1, 2).reshape(B * H, S, P).contiguous(),
                    la.transpose(1, 2).reshape(B * H, S).contiguous(), bt, ct,
                    chunk=chunk)
    assert view.shape == (B, H, S, P)
    assert torch.equal(view.reshape(B * H, S, P), flat)
    model = ssd_chunked_kernel(*_t(x, dt, A, b, c), chunk=chunk)
    assert model.shape == (B, S, H, P)
    assert torch.equal(model, view.transpose(1, 2))
