"""The f32 flash kernel's arithmetic, emulated on the CPU.

``csrc/flash_attention.cu:flash_fwd_kernel_tf32`` runs only on the card.
Its schedule and rounding are repeated here in torch: 128-row q blocks of
two 64-row warpgroups (``Q_TILE``), K/V tiles of ``KEY_TILE`` keys (64 at
hd 64, 32 at hd 128), the KV loop from the window's first tile to the
causal frontier, tiles no row of a warpgroup sees skipped, the mask applied
only where the kernel applies it, keys past Sk zero (TMA's fill), the
online softmax with exp2 and the scale folded in, and every product as
three TF32 products (x -> hi = tf32(x), lo = tf32(x - hi) by
``cvt.rna.tf32.f32`` on the int32 bits; lo*hi + hi*lo + hi*hi, f32 sums).
The emulation is held at the card's f32 check (rtol = atol = 2e-5, the
tolerance ``chip_smoke.py`` and ``tests/test_torch_gpu.py`` hold the kernel
to) against ``flash_attention_plain`` and against the reference's Pallas
``flash_attention`` in interpret mode, on the same numpy inputs, at reduced
sizes of the card's f32 cases. One TF32 product per product misses that
check, so the split is what passes it.
"""
import importlib
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as ref_flash
from repro_torch.kernels.flash_attention import (KEY_TILE, Q_TILE,
                                                 flash_attention_plain)

# the module (the package's ``flash_attention`` attribute is the function)
fa = importlib.import_module("repro_torch.kernels.flash_attention")

CARD_F32_TOL = dict(rtol=2e-5, atol=2e-5)
SOURCE = Path(fa.__file__).resolve().parents[1] / "csrc" / "flash_attention.cu"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: round to 10 mantissa bits, nearest, ties away
    from zero, on the int32 bits (add half of the dropped range, clear the
    low 13 bits); inf stays inf, NaN stays NaN."""
    bits = x.contiguous().view(torch.int32)
    out = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isnan(x), x, out)


def _product(a, b, three: bool):
    """a @ b with TF32 operands: three products (the kernel's) or one."""
    if not three:
        return tf32(a) @ tf32(b)
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _emulate_f32_kernel(q, k, v, *, causal, window, three=True):
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    bq, bk = Q_TILE[torch.float32], KEY_TILE[(torch.float32, hd)]
    c = hd ** -0.5 * math.log2(math.e)
    pad = -(-Sk // bk) * bk - Sk
    kk = torch.nn.functional.pad(k, (0, 0, 0, pad)).repeat_interleave(G, 1)
    vv = torch.nn.functional.pad(v, (0, 0, 0, pad)).repeat_interleave(G, 1)
    out = torch.zeros((B, H, Sq, hd))
    for q0 in range(0, Sq, bq):
        q_last = min(q0 + bq, Sq) - 1
        k_lo = max(0, q0 - window + 1) if window else 0
        k_hi = min(Sk, q_last + 1) if causal else Sk
        t_lo = k_lo // bk
        n_tiles = max(0, -(-k_hi // bk) - t_lo)
        for r_lo in range(q0, min(q0 + bq, Sq), 64):
            r_hi = r_lo + 63
            rows = torch.arange(r_lo, min(r_hi + 1, Sq))
            m = torch.full((B, H, len(rows)), -math.inf)
            l = torch.zeros((B, H, len(rows)))
            acc = torch.zeros((B, H, len(rows), hd))
            for it in range(n_tiles):
                kt = (t_lo + it) * bk
                if (causal and kt > r_hi) or (window and kt + bk - 1 <= r_lo - window):
                    continue
                s = _product(q[:, :, rows], kk[:, :, kt:kt + bk].transpose(-1, -2),
                             three)
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
                acc = acc * alpha[..., None] + _product(p, vv[:, :, kt:kt + bk], three)
                m = m_new
            out[:, :, rows] = acc / l.clamp_min(1e-30)[..., None]
    return out


def _inputs(B, H, KV, Sq, Sk, hd, seed=11):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for shape in
            ((B, H, Sq, hd), (B, KV, Sk, hd), (B, KV, Sk, hd))]


def _close(out, ref) -> None:
    np.testing.assert_allclose(np.asarray(out, np.float32),
                               np.asarray(ref, np.float32), **CARD_F32_TOL)


@pytest.mark.parametrize("B,H,KV,Sq,Sk,hd,causal,window", [
    (1, 25, 5, 384, 384, 64, True, 96),       # hymba's heads and window
    (1, 4, 2, 1000, 1000, 64, True, 100),     # ragged S
    (1, 4, 2, 512, 1000, 64, False, 0),       # cross, Sk ragged
    (1, 2, 1, 200, 40, 64, True, 16),         # rows that see no key
    (1, 14, 2, 300, 300, 128, True, 0),       # hd 128 at G = 7 (llava), ragged
    (1, 4, 2, 300, 400, 128, False, 50),      # hd 128, a window, not causal
])
def test_3xtf32_schedule_matches_plain_and_pallas(B, H, KV, Sq, Sk, hd, causal,
                                                  window):
    q, k, v = _inputs(B, H, KV, Sq, Sk, hd)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out = _emulate_f32_kernel(tq, tk, tv, causal=causal, window=window)
    _close(out, flash_attention_plain(tq, tk, tv, causal=causal, window=window))
    ref = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=causal, window=window, block_q=Sq, block_k=Sk,
                    interpret=True)
    _close(out, ref)
    if causal and window and Sq >= Sk + window:
        assert (out[:, :, Sk + window - 1:] == 0).all()


def test_one_tf32_product_misses_the_f32_check():
    """The split guards the tolerance: with one TF32 product per product the
    same schedule misses rtol = atol = 2e-5 several-fold (by ~9x: its
    worst |out - plain| - rtol |plain| is ~1.8e-4), the three products
    pass it with ~100x to spare."""
    q, k, v = map(torch.from_numpy, _inputs(1, 4, 2, 1024, 1024, 64, seed=5))
    ref = flash_attention_plain(q, k, v, causal=False)
    err = {three: float(((_emulate_f32_kernel(q, k, v, causal=False, window=0,
                                              three=three) - ref).abs()
                         - 2e-5 * ref.abs()).max())
           for three in (True, False)}
    assert err[True] <= 2e-5 / 10 and err[False] > 4 * 2e-5, err


def test_tf32_rounding_helper():
    """Ties away from zero, both signs; zero, inf and NaN pass through."""
    def f(bits):
        return torch.tensor(bits, dtype=torch.int64).to(torch.int32).view(
            torch.float32)

    one = 0x3F800000
    x = f([one + 0x1000, one + 0x0FFF, one + 0x3000, one + 0x1001,
           one + 0x2000, (one + 0x1000) | 0x80000000, 0, 0x80000000])
    want = f([one + 0x2000, one, one + 0x4000, one + 0x2000, one + 0x2000,
              (one + 0x2000) | 0x80000000, 0, 0x80000000])
    assert torch.equal(tf32(x).view(torch.int32), want.view(torch.int32))
    assert torch.equal(tf32(torch.tensor([1.0, -2.5, 3.0])),
                       torch.tensor([1.0, -2.5, 3.0]))
    special = tf32(torch.tensor([math.inf, -math.inf, math.nan]))
    assert special[0] == math.inf and special[1] == -math.inf
    assert torch.isnan(special[2])
    # hi + lo carries 21 bits of the mantissa; one tf32 value 11
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096)
                         .astype(np.float32))
    hi = tf32(x)
    lo = tf32(x - hi)
    assert float(((hi - x) / x).abs().max()) <= 2.0 ** -11
    assert float(((hi + lo - x) / x).abs().max()) <= 2.0 ** -21


def test_tiles_are_the_sources():
    """The emulation's tiles (the wrapper's constants, checked against the
    built library when it loads) are the ones the source states."""
    text = SOURCE.read_text()
    f32 = re.search(r"key_tile\(\) \{ return HD == 64 \? (\d+) : (\d+); \}", text)
    assert f32 and (int(f32[1]), int(f32[2])) == (KEY_TILE[(torch.float32, 64)],
                                                  KEY_TILE[(torch.float32, 128)])
    bf16 = re.search(r"constexpr int BKT = (\d+);", text)
    assert all(KEY_TILE[(torch.bfloat16, hd)] == int(bf16[1]) for hd in (64, 128))
    consumers = re.findall(r"constexpr int kConsumers = (\d+);", text)
    assert len(consumers) == 2 and all(64 * int(n) == Q_TILE[dt] for n, dt in
                                       zip(consumers, (torch.bfloat16, torch.float32)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grid_check_uses_the_dtypes_q_tile(dtype, monkeypatch):
    """The wrapper refuses a problem whose q tiles overflow the grid's z
    extent, counted with the tile of the dtype's own kernel."""
    def check(Sq):
        q = torch.empty((1, 2, Sq, 64), dtype=dtype, device="meta")
        k = torch.empty((1, 1, 16, 64), dtype=dtype, device="meta")
        fa._check(q, k, k, 0)

    check(65535 * Q_TILE[dtype])
    with pytest.raises(ValueError, match="out of range"):
        check(65535 * Q_TILE[dtype] + 1)
    other = torch.bfloat16 if dtype == torch.float32 else torch.float32
    monkeypatch.setitem(fa.Q_TILE, other, Q_TILE[other] // 2)
    check(65535 * Q_TILE[dtype])             # the other dtype's tile is not read
    monkeypatch.setitem(fa.Q_TILE, dtype, Q_TILE[dtype] // 2)
    with pytest.raises(ValueError, match="out of range"):
        check(65535 * 128)
