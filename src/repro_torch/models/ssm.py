"""Mamba2 SSD (state-space duality) blocks: chunked parallel scan for
prefill and O(1)-state single-token decode (port of ``repro.models.ssm``).

SSD recurrence (per head, head dim P, state dim N):

    h_t = a_t * h_{t-1} + b_t x_t^T        h in R^{N x P}
    y_t = c_t^T h_t                        (+ D x_t skip)

with a_t = exp(-softplus(A_log) * dt_t) scalar per head, b_t, c_t in R^N
(shared across heads in the Mamba2 "multi-value" layout), x_t in R^P.

The chunked algorithm (arXiv:2405.21060 §6) splits the sequence into chunks
of length Q: within-chunk terms are a masked matmul (causal linear
attention), and the cross-chunk term is a short sequential scan over chunk
states. :func:`chunk_scan` is that algorithm on pre-scaled inputs; it is
both :func:`ssd_chunked`'s core and the plain version of the CUDA kernel
``kernels/ssd_scan.py``, which the model calls.
"""
from __future__ import annotations

import torch

__all__ = ["ssd_reference", "ssd_chunked", "ssd_decode_step", "chunk_scan"]

_F32 = torch.float32


def ssd_reference(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  b: torch.Tensor, c: torch.Tensor,
                  h0: torch.Tensor | None = None):
    """Sequential-scan oracle. Shapes:

    x: (B, S, H, P)   inputs per head
    dt: (B, S, H)     positive step sizes (post-softplus)
    A: (H,)           positive decay rates (post-softplus of A_log)
    b, c: (B, S, N)   input/output projections (shared across heads)
    h0: (B, H, N, P)  optional initial state.

    Returns (y (B,S,H,P), h_final (B,H,N,P)).
    """
    B, S, H, P = x.shape
    N = b.shape[-1]
    a = torch.exp(-A[None, None, :] * dt)                     # (B, S, H)
    h = (torch.zeros((B, H, N, P), dtype=_F32, device=x.device)
         if h0 is None else h0)
    xf, bf, cf = x.to(_F32), b.to(_F32), c.to(_F32)
    ys = []
    for t in range(S):
        upd = torch.einsum("bn,bhp->bhnp", bf[:, t],
                           xf[:, t] * dt[:, t, :, None])
        h = a[:, t, :, None, None] * h + upd
        ys.append(torch.einsum("bn,bhnp->bhp", cf[:, t], h))
    return torch.stack(ys, 1).to(x.dtype), h


def chunk_scan(xdt: torch.Tensor, la: torch.Tensor, b: torch.Tensor,
               c: torch.Tensor, *, chunk: int,
               h0: torch.Tensor | None = None):
    """Chunked SSD on pre-scaled inputs, in f32.

    xdt: (G, r, S, P) = x * dt; la: (G, r, S) = -A * dt; b, c: (G, S, N),
    shared by the r heads of a group; h0: (G, r, N, P) or None. S must be a
    multiple of ``chunk``. Returns (y (G, r, S, P) f32, h_final).
    """
    G, r, S, P = xdt.shape
    N = b.shape[-1]
    assert S % chunk == 0, (S, chunk)
    nC = S // chunk
    x = xdt.to(_F32).reshape(G, r, nC, chunk, P)
    cum = la.to(_F32).reshape(G, r, nC, chunk).cumsum(-1)     # log prod_{<=i}
    tot = cum[..., -1]                                        # (G, r, nC)
    bc = b.to(_F32).reshape(G, 1, nC, chunk, N)
    cc = c.to(_F32).reshape(G, 1, nC, chunk, N)

    # within-chunk (dual / linear-attention) term:
    # L[i, j] = exp(cum_i - cum_j) for i >= j (decay from j+1..i), else 0
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=x.device).tril()
    lmat = (cum[..., :, None] - cum[..., None, :]).masked_fill_(
        ~causal, float("-inf")).exp_()                       # (G,r,nC,Q,Q)
    y = ((cc @ bc.transpose(-1, -2)) * lmat) @ x              # (G,r,nC,Q,P)

    # chunk states: sum_j exp(tot - cum_j) b_j x_j^T
    w = torch.exp(tot[..., None] - cum)                       # (G,r,nC,Q)
    states = bc.transpose(-1, -2) @ (w[..., None] * x)        # (G,r,nC,N,P)

    # cross-chunk sequential scan over the nC chunk states
    h = (torch.zeros((G, r, N, P), dtype=_F32, device=x.device)
         if h0 is None else h0.to(_F32))
    decay = torch.exp(tot)
    h_ins = []
    for k in range(nC):
        h_ins.append(h)                                       # state entering k
        h = decay[..., k, None, None] * h + states[:, :, k]
    h_in = torch.stack(h_ins, 2)                              # (G,r,nC,N,P)

    # inter-chunk output term
    y += torch.exp(cum)[..., None] * (cc @ h_in)
    return y.reshape(G, r, S, P), h


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, *, chunk: int = 64,
                h0: torch.Tensor | None = None):
    """Chunked SSD (the duality form). Same signature as
    :func:`ssd_reference`; S must be a multiple of ``chunk``."""
    xdt = (x.to(_F32) * dt[..., None]).permute(0, 2, 1, 3)    # (B, H, S, P)
    la = (-A[None, None, :] * dt).to(_F32).permute(0, 2, 1)   # (B, H, S)
    y, h = chunk_scan(xdt, la, b, c, chunk=chunk, h0=h0)
    return y.permute(0, 2, 1, 3).to(x.dtype), h


def ssd_decode_step(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    b: torch.Tensor, c: torch.Tensor, h: torch.Tensor):
    """One-token decode. x: (B,H,P); dt: (B,H); b,c: (B,N); h: (B,H,N,P).

    Returns (y (B,H,P), h_next).
    """
    a = torch.exp(-A[None, :] * dt)                           # (B, H)
    upd = torch.einsum("bn,bhp->bhnp", b.to(_F32),
                       x.to(_F32) * dt[..., None])
    h = a[..., None, None] * h + upd
    y = torch.einsum("bn,bhnp->bhp", c.to(_F32), h)
    return y.to(x.dtype), h
