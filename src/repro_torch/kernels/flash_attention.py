"""GQA flash attention: a hand-written CUDA kernel for Hopper
(``csrc/flash_attention.cu``) and its plain PyTorch version.

:func:`flash_attention` replaces ``repro/kernels/flash_attention.py:
flash_attention``: q (B, H, Sq, hd), k and v (B, KV, Sk, hd) with H = KV * G,
f32 or bf16, causal and/or sliding-window masks, scale ``hd ** -0.5``, f32
softmax statistics and accumulator, output in q's dtype. Unlike the Pallas
kernel it takes any Sq and Sk (the ragged tile is masked in the kernel) and
its KV loop runs only over the tiles a q tile can see. A row with no visible
key gives 0, as the Pallas kernel's ``acc / max(l, 1e-30)`` does.

Bound on an H100 SXM: operations (4 * hd flops per visible (query, key)
pair); the kernel computes in f32 on the CUDA cores (the source's header
has the design).

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor
it computes :func:`flash_attention_plain`, which ``chip_smoke.py`` also
holds the kernel against on the card. ``flash_attention.launches`` counts
the launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import load_library
from repro_torch.models.attention import visible_mask

__all__ = ["flash_attention", "flash_attention_plain", "visible_mask",
           "visible_pairs"]

_LIB = "flash_attention"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_MAX_GRID_YZ = 65535


def visible_pairs(Sq: int, Sk: int, *, causal: bool = True, window: int = 0) -> int:
    """Number of visible (query, key) pairs of one head: the work the
    attention needs (4 * hd flops each)."""
    return int(visible_mask(Sq, Sk, causal, window).sum())


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: int = 0) -> torch.Tensor:
    """Plain PyTorch GQA attention, the kernel's reference (after
    ``repro/kernels/ref.py:flash_attention_ref``): f32 throughout, masked
    scores excluded, a row with no visible key 0, output in q's dtype."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    qr = q.reshape(B, KV, G, Sq, hd).to(torch.float32)
    s = torch.einsum("bkgsd,bktd->bkgst", qr, k.to(torch.float32)) * hd ** -0.5
    mask = visible_mask(Sq, Sk, causal, window, q.device)
    s.masked_fill_(~mask, -1e30)
    p = s.sub_(s.amax(-1, keepdim=True)).exp_().mul_(mask)
    l = p.sum(-1, keepdim=True).clamp_min_(1e-30)
    out = torch.einsum("bkgst,bktd->bkgsd", p, v.to(torch.float32)).div_(l)
    return out.reshape(B, H, Sq, hd).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = load_library(_LIB).flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (B, H, Sq, hd) and k, v (B, KV, Sk, hd); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or KV < 1 or H % KV:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         "form a GQA problem (same B and hd, H % KV == 0)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one of {list(_DTYPES)}; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {_HEAD_DIMS}")
    if min(B, H, Sq, Sk) < 1 or max(B, H) > _MAX_GRID_YZ or window < 0:
        raise ValueError(f"shape {tuple(q.shape)} / window {window} out of range")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, H, Sq, hd); k, v (B, KV, Sk, hd) -> (B, H, Sq, hd) in q's dtype."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU, not {q.device}")
    _check(q, k, v, window)
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    with torch.cuda.device(q.device):
        out = torch.empty_like(q)
        err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), _DTYPES[q.dtype], B, H, KV, Sq, Sk,
                        hd, int(bool(causal)), int(window), hd ** -0.5,
                        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
