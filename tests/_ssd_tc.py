"""The tensor-core SSD scan's arithmetic (``csrc/ssd_scan.cu:ssd_scan_tc``),
emulated in torch on the CPU.

The kernel runs only on the card. Its schedule and rounding are repeated
here: tiles of ``TILE`` tokens walked in order whatever the caller's chunk
(rows past S zero-filled), cum = cumsum(la) inside the tile times log2(e),
and per tile

    G = C B^T,  M = G o exp2(cum2_i - cum2_j) (exponent -inf above the
    diagonal), y = exp2(cum2) o (C h) + M X,
    h = exp2(tot2) h + ((B_hi + B_lo) o exp2(tot2 - cum2))^T X

with every product as three TF32 products (x -> hi = tf32(x), lo =
tf32(x - hi) by ``cvt.rna.tf32.f32`` on the int32 bits; lo hi + hi lo +
hi hi, f32 sums), or as one (``three=False``), and the state update skipped
after the last tile.
"""
import math

import torch
import torch.nn.functional as F

LOG2E = 1.4426950408889634


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: round to 10 mantissa bits, nearest, ties away
    from zero, on the int32 bits (add half of the dropped range, clear the
    low 13 bits); inf stays inf, NaN stays NaN."""
    bits = x.contiguous().view(torch.int32)
    out = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isnan(x), x, out)


def product(a: torch.Tensor, b: torch.Tensor, three: bool = True) -> torch.Tensor:
    """a @ b with TF32 operands: three products (the kernel's) or one."""
    if not three:
        return tf32(a) @ tf32(b)
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def emulate_tc_scan(xdt, la, b, c, *, tile: int = 64,
                    three: bool = True) -> torch.Tensor:
    """xdt (G, r, S, P), la (G, r, S), b, c (G, S, N), f32 -> y (G, r, S,
    P), in the kernel's order and rounding."""
    G, r, S, P = xdt.shape
    N = b.shape[-1]
    nT = math.ceil(S / tile)
    pad = nT * tile - S
    X = F.pad(xdt, (0, 0, 0, pad))
    L = F.pad(la, (0, pad))
    Bp, Cp = F.pad(b, (0, 0, 0, pad)), F.pad(c, (0, 0, 0, pad))
    i = torch.arange(tile)
    below = i[None, :] <= i[:, None]                    # [i][j]: j <= i
    h = torch.zeros((G, r, N, P))
    y = torch.empty((G, r, nT * tile, P))
    for t in range(nT):
        sl = slice(t * tile, (t + 1) * tile)
        Xt, Bt, Ct = X[:, :, sl], Bp[:, sl], Cp[:, sl]
        cum2 = L[:, :, sl].cumsum(-1) * LOG2E           # (G, r, T)
        tot2 = cum2[..., -1]
        g = product(Ct, Bt.transpose(-1, -2), three)    # (G, T, T)
        arg = torch.where(below, cum2[..., :, None] - cum2[..., None, :],
                          -math.inf)
        yt = product(g[:, None] * torch.exp2(arg), Xt, three)
        if t > 0:
            yt = torch.exp2(cum2)[..., None] * product(Ct[:, None], h, three) + yt
        y[:, :, sl] = yt
        if t + 1 < nT:
            hi = tf32(Bt)
            bw = (hi + tf32(Bt - hi))[:, None] * torch.exp2(
                tot2[..., None] - cum2)[..., None]      # (G, r, T, N)
            h = (torch.exp2(tot2)[..., None, None] * h
                 + product(bw.transpose(-1, -2), Xt, three))
    return y[:, :, :S]
