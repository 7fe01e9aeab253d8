"""ADEL-FL's layer-wise Eq. 5 fold: hand-written CUDA kernels for Hopper
(``csrc/adel_agg.cu``) and their plain PyTorch versions.

* :func:`adel_agg` replaces ``repro/kernels/adel_agg.py:adel_agg``:
  ``out[l, f] = sum_u coeff[u, l] * grads[u, l, f]``, grads (U, L, F) f32 or
  bf16, coeff (U, L), f32 accumulation, output (L, F) in the grads dtype.
* :func:`adel_agg_q8` replaces ``repro/kernels/adel_agg.py:adel_agg_q8``:
  the fused int8 dequantize + weight + accumulate
  ``out[l, f] = sum_u coeff[u, l] * scales[u, l] * q[u, l, f]``, output f32.

Bound on an H100 SXM (3.35 TB/s): both are memory-bound. ``adel_agg``
moves ``(U + 1) * L * F * itemsize`` bytes, ``adel_agg_q8`` ``U * L * F +
4 * L * F`` bytes; the arithmetic (2 flops per input element) is far below
the card's ridge point. The kernels stream each input byte once with 16-byte
coalesced loads, keep the sums in f32 registers, stage the (U,) weight
column in shared memory, and mask the ragged F edge without a padding copy
(the source's header has the details).

On a CUDA tensor a wrapper launches its kernel or raises; on a CPU tensor
it computes the plain version (an einsum in f32), which is also what
``chip_smoke.py`` holds each kernel against on the card. Each wrapper
counts its launches in ``.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import load_library

__all__ = ["adel_agg", "adel_agg_q8", "adel_agg_plain", "adel_agg_q8_plain"]

_LIB = "adel_agg"
_MAX_U = 12 * 1024            # (U,) f32 weights in 48 KB of shared memory
_MAX_L = 65535                # grid.y


def adel_agg_plain(grads: torch.Tensor, coeff: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch Eq. 5 fold, the kernel's reference: (L, F) in grads' dtype."""
    return torch.einsum("ul,ulf->lf", coeff.to(torch.float32),
                        grads.to(torch.float32)).to(grads.dtype)


def adel_agg_q8_plain(q: torch.Tensor, scales: torch.Tensor,
                      coeff: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch fused int8 fold, the kernel's reference: (L, F) f32."""
    w = coeff.to(torch.float32) * scales.to(torch.float32)
    return torch.einsum("ul,ulf->lf", w, q.to(torch.float32))


def _check(x: torch.Tensor, weights: tuple[torch.Tensor, ...], dtypes) -> tuple:
    if x.dim() != 3:
        raise ValueError(f"expected a (U, L, F) tensor, got {tuple(x.shape)}")
    if x.dtype not in dtypes:
        raise TypeError(f"unsupported dtype {x.dtype}; takes {dtypes}")
    U, L, F = x.shape
    if not 1 <= U <= _MAX_U or not 1 <= L <= _MAX_L or F < 1:
        raise ValueError(f"shape {tuple(x.shape)} outside U <= {_MAX_U}, "
                         f"L <= {_MAX_L}, F >= 1")
    if not x.is_contiguous():
        raise ValueError("the (U, L, F) input must be contiguous")
    for w in weights:
        if w.shape != (U, L):
            raise ValueError(f"weights {tuple(w.shape)} != {(U, L)}")
        if w.device != x.device:
            raise ValueError(f"weights on {w.device}, input on {x.device}")
    return U, L, F


def _f32(w: torch.Tensor) -> torch.Tensor:
    return w.to(torch.float32).contiguous()


def _launch(fn, *args) -> None:
    err = fn(*args, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        raise RuntimeError(f"CUDA kernel launch failed: error {err}")


@functools.lru_cache(maxsize=None)
def _kernel(name: str):
    """The C entry point ``name`` of the built library, with its signature:
    ``n`` data pointers, then (int U, int L, long long F, stream)."""
    n_ptr = 4 if name == "adel_agg_q8" else 3
    fn = getattr(load_library(_LIB), name)
    fn.argtypes = ([ctypes.c_void_p] * n_ptr
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def adel_agg(grads: torch.Tensor, coeff: torch.Tensor) -> torch.Tensor:
    """grads (U, L, F) f32/bf16, coeff (U, L) -> (L, F) in grads' dtype."""
    if grads.device.type == "cpu":
        return adel_agg_plain(grads, coeff)
    if grads.device.type != "cuda":
        raise ValueError(f"adel_agg runs on CUDA or CPU, not {grads.device}")
    U, L, F = _check(grads, (coeff,), (torch.float32, torch.bfloat16))
    c = _f32(coeff)
    with torch.cuda.device(grads.device):
        out = torch.empty((L, F), dtype=grads.dtype, device=grads.device)
        name = "adel_agg_f32" if grads.dtype == torch.float32 else "adel_agg_bf16"
        _launch(_kernel(name), grads.data_ptr(), c.data_ptr(),
                out.data_ptr(), U, L, F)
    adel_agg.launches += 1
    return out


def adel_agg_q8(q: torch.Tensor, scales: torch.Tensor,
                coeff: torch.Tensor) -> torch.Tensor:
    """q (U, L, F) int8, scales and coeff (U, L) -> (L, F) f32."""
    if q.device.type == "cpu":
        return adel_agg_q8_plain(q, scales, coeff)
    if q.device.type != "cuda":
        raise ValueError(f"adel_agg_q8 runs on CUDA or CPU, not {q.device}")
    U, L, F = _check(q, (scales, coeff), (torch.int8,))
    s, c = _f32(scales), _f32(coeff)
    with torch.cuda.device(q.device):
        out = torch.empty((L, F), dtype=torch.float32, device=q.device)
        _launch(_kernel("adel_agg_q8"), q.data_ptr(), s.data_ptr(),
                c.data_ptr(), out.data_ptr(), U, L, F)
    adel_agg_q8.launches += 1
    return out


adel_agg.launches = 0
adel_agg_q8.launches = 0
