"""The tensor-core SSD scan's arithmetic, emulated on the CPU.

``csrc/ssd_scan.cu:ssd_scan_tc`` runs only on the card. ``tests/_ssd_tc.py``
repeats its schedule and rounding in torch: 64-token tiles walked in order
whatever the chunk, rows past S zero, cum in log2 units, the decay's
exponent -inf above the diagonal before the exp, the inter term scaled into
y before the intra term, B read back as hi + lo for the state update, and
every product as three TF32 products (``cvt.rna.tf32.f32`` on the int32
bits). The emulation is held at the card's SSD check (rtol = atol = 1e-4,
the tolerance ``chip_smoke.py`` and ``tests/test_torch_gpu.py`` hold the
kernel to) against ``ssd_scan_plain`` and against the reference's Pallas
``ssd_scan`` in interpret mode, on the same numpy inputs, at reduced sizes
of the card's cases. One TF32 product per product misses that check, so
the split is what passes it.
"""
import importlib
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _ssd_tc import emulate_tc_scan, tf32
from repro.kernels.ssd_scan import ssd_scan as ref_ssd_scan

# the module (the package's ``ssd_scan`` attribute is the function)
mod = importlib.import_module("repro_torch.kernels.ssd_scan")

CARD_SSD_TOL = dict(rtol=1e-4, atol=1e-4)
SOURCE = Path(mod.__file__).resolve().parents[1] / "csrc" / "ssd_scan.cu"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(G, r, S, P, N, seed=3):
    rng = np.random.default_rng(seed)
    xdt = rng.standard_normal((G, r, S, P)).astype(np.float32)
    la = -rng.uniform(size=(G, r, S)).astype(np.float32)
    b = (0.3 * rng.standard_normal((G, S, N))).astype(np.float32)
    c = (0.3 * rng.standard_normal((G, S, N))).astype(np.float32)
    return xdt, la, b, c


def _close(out, ref) -> None:
    np.testing.assert_allclose(np.asarray(out, np.float32),
                               np.asarray(ref, np.float32), **CARD_SSD_TOL)


def _pallas(xdt, la, b, c, Q):
    G, r, S, P = xdt.shape
    N = b.shape[-1]
    per_head = [np.broadcast_to(t[:, None], (G, r, S, N)).reshape(G * r, S, N)
                for t in (b, c)]
    y = ref_ssd_scan(jnp.asarray(xdt.reshape(G * r, S, P)),
                     jnp.asarray(la.reshape(G * r, S)),
                     *map(jnp.asarray, per_head), chunk=Q, interpret=True)
    return np.asarray(y).reshape(G, r, S, P)


@pytest.mark.parametrize("G,r,S,P,N,Q", [
    (2, 4, 256, 50, 16, 64),     # hymba-1.5b's widths
    (1, 2, 192, 64, 128, 64),    # mamba2-370m's widths: two state row tiles
    (2, 3, 256, 16, 8, 128),     # a long chunk: two tiles a chunk
    (3, 1, 96, 7, 5, 16),        # per-head b, c (G = BH), odd widths, a last
                                 # tile past S
    (1, 2, 96, 12, 40, 32),      # chunk 32, N past one box of 32 columns
])
def test_tc_schedule_matches_plain_and_pallas(G, r, S, P, N, Q):
    arrays = _inputs(G, r, S, P, N)
    out = emulate_tc_scan(*map(torch.from_numpy, arrays))
    xdt, la, b, c = map(torch.from_numpy, arrays)
    _close(out, mod.ssd_scan_plain(xdt, la, b, c, chunk=Q))
    _close(out, _pallas(*arrays, Q))


def test_one_tf32_product_misses_the_check():
    """The split guards the tolerance: with one TF32 product per product the
    same schedule misses rtol = atol = 1e-4 at hymba-1.5b's widths several
    times over; the three products pass it with room to spare."""
    xdt, la, b, c = map(torch.from_numpy, _inputs(2, 4, 256, 50, 16, seed=5))
    ref = mod.ssd_scan_plain(xdt, la, b, c, chunk=64)
    over = {three: float(((emulate_tc_scan(xdt, la, b, c, three=three) - ref)
                          .abs() - 1e-4 * ref.abs()).max())
            for three in (True, False)}
    assert over[True] <= 1e-4 / 4 and over[False] > 4 * 1e-4, over


def test_tf32_rounding_helper():
    """Ties away from zero, both signs; zero, inf and NaN pass through; hi +
    lo carries 21 bits of the mantissa, one tf32 value 11."""
    def f(bits):
        return torch.tensor(bits, dtype=torch.int64).to(torch.int32).view(
            torch.float32)

    one = 0x3F800000
    x = f([one + 0x1000, one + 0x0FFF, (one + 0x1000) | 0x80000000, 0])
    want = f([one + 0x2000, one, (one + 0x2000) | 0x80000000, 0])
    assert torch.equal(tf32(x).view(torch.int32), want.view(torch.int32))
    special = tf32(torch.tensor([float("inf"), float("nan")]))
    assert special[0] == float("inf") and torch.isnan(special[1])
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096)
                         .astype(np.float32))
    hi = tf32(x)
    assert float(((hi - x) / x).abs().max()) <= 2.0 ** -11
    assert float(((hi + tf32(x - hi) - x) / x).abs().max()) <= 2.0 ** -21


def test_tile_is_the_sources():
    """The emulation walks the kernel's tile: the wrapper's TILE (checked
    against the built library on the card) is the source's kT, and the P
    widths a block takes are the source's."""
    text = SOURCE.read_text()
    tile = re.search(r"constexpr int kT = (\d+);", text)
    assert tile and int(tile[1]) == mod.TILE == 64
    widths = re.search(r"constexpr int kWidths\[\] = \{([\d, ]+)\};", text)
    assert widths and [int(w) for w in widths[1].split(",")] == [16, 32, 56, 64]


def test_fragment_token_order_is_the_product():
    """The kernel's index maps, as its source computes them: G's accumulator
    fragment handed to the intra product as A fragments (quad q of k-step
    e / 4 from element e), against X^T written with tokens 8 q + 2 i + half
    at positions 8 q + 4 half + i, multiply out to G X."""
    rng = np.random.default_rng(1)
    T, PW = 64, 16
    G = rng.standard_normal((T, T))
    X = rng.standard_normal((T, PW))
    xt = np.zeros((PW, T))                      # X^T as the split pass writes it
    for p in range(PW):
        for q in range(8):
            for half in range(2):
                for i in range(4):
                    xt[p, 8 * q + 4 * half + i] = X[8 * q + 2 * i + half, p]
    A = np.full((T, T), np.nan)                 # the A operand the fragments form
    for tid in range(128):
        warp, lane = divmod(tid, 32)
        row0, t4 = 16 * warp + lane // 4, lane % 4
        for e in range(32):
            r8, c1 = (e >> 1) & 1, e & 1
            g = G[row0 + 8 * r8, 8 * (e >> 2) + 2 * t4 + c1]
            q = (c1 << 1) | r8                  # quad: (row0, t), (row0 + 8, t),
            row = row0 + 8 * (q & 1)            # (row0, t + 4), (row0 + 8, t + 4)
            col = 8 * (e >> 2) + t4 + 4 * (q >> 1)
            A[row, col] = g
    assert not np.isnan(A).any()
    np.testing.assert_allclose(A @ xt.T, G @ X, rtol=1e-12, atol=1e-12)
