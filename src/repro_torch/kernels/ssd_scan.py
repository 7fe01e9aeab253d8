"""Mamba2 SSD chunk scan: a hand-written CUDA kernel for Hopper
(``csrc/ssd_scan.cu``) and its plain PyTorch version.

:func:`ssd_scan` replaces ``repro/kernels/ssd_scan.py:ssd_scan``: inputs
pre-scaled by the caller, ``xdt = x * dt`` (BH, S, P) and ``la = -A * dt``
(BH, S), with ``b`` and ``c`` (G, S, N) read per group: head ``bh`` uses row
``bh // (BH // G)``. The model passes its per-batch projections (G = B), so
nothing is copied out per head; ``G = BH`` is the reference's per-head
layout. Per chunk of Q = min(chunk, S) tokens it forms the within-chunk
dual term and carries an f32 (N, P) state across chunks; y (BH, S, P) f32.
``S % Q == 0`` is the caller's job, as in the reference.

Bound on an H100 SXM: near the f32 ridge at the model's shapes (the
source's header has the counts and the design).

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor
it computes :func:`ssd_scan_plain` (the chunked SSD algorithm of
``models/ssm.py``, in f32), which ``chip_smoke.py`` also holds the kernel
against on the card. ``ssd_scan.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import load_library
from repro_torch.models.ssm import chunk_scan

__all__ = ["ssd_scan", "ssd_scan_plain"]

_LIB = "ssd_scan"
_INVALID_VALUE = 1            # cudaErrorInvalidValue


def _shapes(xdt, b, chunk: int) -> tuple:
    BH, S, P = xdt.shape
    G, _, N = b.shape
    return BH, G, S, P, N, min(chunk, S)


def ssd_scan_plain(xdt: torch.Tensor, la: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, *, chunk: int = 64) -> torch.Tensor:
    """Plain PyTorch SSD chunk scan, the kernel's reference: y (BH, S, P)
    in xdt's dtype, computed in f32."""
    BH, G, S, P, N, Q = _shapes(xdt, b, chunk)
    r = BH // G
    y, _ = chunk_scan(xdt.reshape(G, r, S, P), la.reshape(G, r, S), b, c,
                      chunk=Q)
    return y.reshape(BH, S, P).to(xdt.dtype)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = load_library(_LIB).ssd_scan_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(xdt, la, b, c, chunk: int) -> tuple:
    if xdt.dim() != 3 or la.dim() != 2 or b.dim() != 3 or c.shape != b.shape:
        raise ValueError(f"expected xdt (BH, S, P), la (BH, S), b, c (G, S, N);"
                         f" got {tuple(xdt.shape)}, {tuple(la.shape)}, "
                         f"{tuple(b.shape)}, {tuple(c.shape)}")
    BH, G, S, P, N, Q = _shapes(xdt, b, chunk)
    if la.shape != (BH, S) or b.shape[1] != S or G < 1 or BH % G:
        raise ValueError(f"la {tuple(la.shape)} / b {tuple(b.shape)} do not "
                         f"match xdt {tuple(xdt.shape)} (BH % G == 0)")
    if Q < 1 or S % Q:
        raise ValueError(f"S = {S} is not a multiple of the chunk {Q}; the "
                         "caller pads")
    for t in (xdt, la, b, c):
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_scan takes float32 inputs, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("ssd_scan inputs must be contiguous")
        if t.device != xdt.device:
            raise ValueError(f"inputs on {t.device} and {xdt.device}")
    return BH, G, S, P, N, Q


def ssd_scan(xdt: torch.Tensor, la: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, *, chunk: int = 64) -> torch.Tensor:
    """xdt (BH, S, P), la (BH, S), b, c (G, S, N) f32 -> y (BH, S, P) f32."""
    if xdt.device.type == "cpu":
        return ssd_scan_plain(xdt, la, b, c, chunk=chunk)
    if xdt.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on CUDA or CPU, not {xdt.device}")
    BH, G, S, P, N, Q = _check(xdt, la, b, c, chunk)
    with torch.cuda.device(xdt.device):
        y = torch.empty_like(xdt)
        err = _kernel()(xdt.data_ptr(), la.data_ptr(), b.data_ptr(),
                        c.data_ptr(), y.data_ptr(), BH, G, S, P, N, Q,
                        torch.cuda.current_stream().cuda_stream)
    if err == _INVALID_VALUE:   # the sizes passed _check; the tiles do not fit
        raise ValueError(f"chunk {Q}, P {P}, N {N} need more shared memory "
                         "than a block may have")
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: error {err}")
    ssd_scan.launches += 1
    return y


ssd_scan.launches = 0
