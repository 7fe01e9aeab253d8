"""GQA flash attention: two hand-written CUDA kernels for Hopper
(``csrc/flash_attention.cu``) and their plain PyTorch version.

:func:`flash_attention` replaces ``repro/kernels/flash_attention.py:
flash_attention``: q (B, H, Sq, hd), k and v (B, KV, Sk, hd) with H = KV * G,
f32 or bf16, causal and/or sliding-window masks, scale ``hd ** -0.5``, f32
softmax statistics and accumulator, output in q's dtype. Unlike the Pallas
kernel it takes any Sq and Sk (the ragged tile is masked in the kernel) and
its KV loop runs only over the tiles a q tile can see. A row with no visible
key gives 0, as the Pallas kernel's ``acc / max(l, 1e-30)`` does.

The dtype picks the kernel, both on the tensor cores (``wgmma`` fed by TMA,
128 q rows a block, :data:`Q_TILE`): bf16 with P split into bf16 hi + lo
parts, 128-key tiles; f32 in 3xTF32, every operand split into tf32 hi + lo
parts and each product taken as lo*hi + hi*lo + hi*hi, with V transposed in
shared memory on the way (tf32 ``wgmma`` reads its B operand K-major only),
64-key tiles at hd 64 and 32 at hd 128 (:data:`KEY_TILE`: shared memory,
160 and 224 KB a block, is the binding limit). Both read q, k and v and
write the output through their strides (:func:`kernel_strides`), so the
model's (B, S, H, hd) layout needs no copy; the output takes q's layout.
Bound on an H100 SXM: operations (4 * hd flops per visible (query, key)
pair), at 989 TFLOP/s in bf16 and 495 / 3 in f32; the source's header has
the design and the shared-memory budget.

On a CUDA tensor the wrapper launches a kernel or raises; on a CPU tensor
it computes :func:`flash_attention_plain`, which ``chip_smoke.py`` also
holds the kernels against on the card. On a ``meta`` tensor (the dry run,
``launch/dryrun.py``) it takes the plain version's shapes and computes
nothing; the plain version forms every (query, key) score and masks it, so
the dry run counts a causal attention as the full Sq x Sk product, as the
reference's count of its jnp attention does. ``flash_attention.launches`` counts
the launches, and ``flash_attention.shapes`` the same launches by problem
``(B, H, KV, Sq, Sk, hd, causal, window)``.

:class:`FlashAttention` is the wrapper under autograd and ``torch.func``:
its forward is :func:`flash_attention` (the kernel on the card), its
backward plain PyTorch (:func:`flash_attention_backward_plain`: P
recomputed, the kernel's saved output O in ``rowsum(dO * O)``; the
reference has no backward kernel either), and its ``vmap`` rule folds the
vmapped dim into B, so one launch serves every client of a vmapped call.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from repro_torch.kernels.build import PLAIN_DEVICES, load_library
from repro_torch.models.attention import visible_mask

__all__ = ["flash_attention", "flash_attention_plain",
           "flash_attention_backward_plain", "FlashAttention",
           "fold_vmapped", "kernel_strides", "visible_mask", "visible_pairs",
           "Q_TILE", "KEY_TILE"]

_LIB = "flash_attention"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_MAX_GRID_YZ = 65535
_ALIGN = 16                      # bytes: TMA's rule for the base and strides

# q rows a block of each dtype's kernel takes (the grid's z extent is Sq
# over it), and the keys of its K/V tiles by (dtype, hd): the library's
# ``flash_attention_q_tile`` / ``flash_attention_key_tile``, checked when
# it is loaded
Q_TILE = {torch.float32: 128, torch.bfloat16: 128}
KEY_TILE = {(torch.float32, 64): 64, (torch.float32, 128): 32,
            (torch.bfloat16, 64): 128, (torch.bfloat16, 128): 128}


def visible_pairs(Sq: int, Sk: int, *, causal: bool = True, window: int = 0) -> int:
    """Number of visible (query, key) pairs of one head: the work the
    attention needs (4 * hd flops each)."""
    return int(visible_mask(Sq, Sk, causal, window).sum())


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: int = 0) -> torch.Tensor:
    """Plain PyTorch GQA attention, the kernel's reference (after
    ``repro/kernels/ref.py:flash_attention_ref``): f32 throughout, masked
    scores excluded, a row with no visible key 0, output in q's dtype.
    Differentiable: nothing autograd saves is modified in place."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    qr = q.reshape(B, KV, G, Sq, hd).to(torch.float32)
    s = torch.einsum("bkgsd,bktd->bkgst", qr, k.to(torch.float32)) * hd ** -0.5
    mask = visible_mask(Sq, Sk, causal, window, q.device)
    s = s.masked_fill(~mask, -1e30)
    p = (s - s.amax(-1, keepdim=True)).exp() * mask
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgst,bktd->bkgsd", p, v.to(torch.float32)) / l
    return out.reshape(B, H, Sq, hd).to(q.dtype)


def library_tiles(lib) -> tuple[dict, dict]:
    """The (q tile, key tile) dicts the built library reports, keyed as
    :data:`Q_TILE` and :data:`KEY_TILE` are."""
    lib.flash_attention_q_tile.argtypes = [ctypes.c_int]
    lib.flash_attention_key_tile.argtypes = [ctypes.c_int, ctypes.c_int]
    q = {dt: lib.flash_attention_q_tile(code) for dt, code in _DTYPES.items()}
    k = {(dt, hd): lib.flash_attention_key_tile(_DTYPES[dt], hd)
         for dt, hd in KEY_TILE}
    return q, k


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = load_library(_LIB)
    if library_tiles(lib) != (Q_TILE, KEY_TILE):
        raise RuntimeError(f"the flash library's tiles {library_tiles(lib)} "
                           f"are not Q_TILE, KEY_TILE")
    fn = lib.flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.POINTER(ctypes.c_int64),
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def kernel_strides(t: torch.Tensor) -> tuple[int, int, int]:
    """The element strides (b, heads, s) through which the kernels read a
    (B, heads, S, hd) tensor, or ValueError if they cannot: hd must have
    unit stride, and the base address and every other stride must be
    16-byte aligned (TMA's rule, for both kernels). A dim
    of size 1 is never stepped over, so its stride is replaced by hd; a
    broadcast (stride 0) dim is refused. No copy is made."""
    if t.dim() != 4:
        raise ValueError(f"expected a (B, heads, S, hd) tensor, got "
                         f"{tuple(t.shape)}")
    item = t.element_size()
    if t.stride(3) != 1:
        raise ValueError(f"hd must have unit stride; strides {t.stride()}")
    if t.data_ptr() % _ALIGN:
        raise ValueError(f"base address not {_ALIGN}-byte aligned")
    out = []
    for d in range(3):
        st = t.stride(d) if t.shape[d] > 1 else t.shape[3]
        if st == 0 or (st * item) % _ALIGN:
            raise ValueError(f"stride {st} of dim {d} is not a nonzero "
                             f"multiple of {_ALIGN} bytes; strides "
                             f"{t.stride()}")
        out.append(st)
    return tuple(out)


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
    if (min(B, H, Sq, Sk) < 1 or window < 0
            or max(B, H, -(-Sq // Q_TILE[q.dtype])) > _MAX_GRID_YZ):
        raise ValueError(f"shape {tuple(q.shape)} / window {window} out of range")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, H, Sq, hd); k, v (B, KV, Sk, hd) -> (B, H, Sq, hd) in q's dtype,
    laid out as q is where q is dense (a (B, S, H, hd) view in, one out)."""
    if q.device.type in PLAIN_DEVICES:
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA, CPU or meta, not {q.device}")
    _check(q, k, v, window)
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    with torch.cuda.device(q.device):
        out = torch.empty_like(q)
        strides = (ctypes.c_int64 * 12)(
            *(s for t in (q, k, v, out) for s in kernel_strides(t)))
        err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), _DTYPES[q.dtype], B, H, KV, Sq, Sk,
                        hd, int(bool(causal)), int(window), hd ** -0.5,
                        strides, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: error {err}")
    flash_attention.launches += 1
    flash_attention.shapes[(B, H, KV, Sq, Sk, hd, bool(causal),
                            int(window))] += 1
    return out


flash_attention.launches = 0
flash_attention.shapes = collections.Counter()


def flash_attention_backward_plain(q, k, v, o, do, *, causal: bool = True,
                                   window: int = 0) -> tuple:
    """(dq, dk, dv) of :func:`flash_attention` in plain PyTorch, f32 inside,
    each in its input's dtype: with P the softmax recomputed under the same
    mask, ``dV = P^T dO``, ``dS = P * (dO V^T - rowsum(dO * O))`` and
    ``dQ = dS K``, ``dK = dS^T Q``, both scaled by ``hd ** -0.5``; GQA sums
    the G q heads of a KV head. ``o`` is the forward's output. Nothing is
    modified in place, so it runs under ``torch.func.vmap``."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    f32, scale = torch.float32, hd ** -0.5

    def heads(t):
        return t.reshape(B, KV, G, Sq, hd).to(f32)

    qr, dor, orr = heads(q), heads(do), heads(o)
    kf, vf = k.to(f32), v.to(f32)
    mask = visible_mask(Sq, Sk, causal, window, q.device)
    s = torch.einsum("bkgsd,bktd->bkgst", qr, kf) * scale
    s = s.masked_fill(~mask, -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True)) * mask
    p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
    dv = torch.einsum("bkgst,bkgsd->bktd", p, dor)
    dp = torch.einsum("bkgsd,bktd->bkgst", dor, vf)
    ds = p * (dp - (dor * orr).sum(-1, keepdim=True)) * scale
    dq = torch.einsum("bkgst,bktd->bkgsd", ds, kf)
    dk = torch.einsum("bkgst,bkgsd->bktd", ds, qr)
    return (dq.reshape(B, H, Sq, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def fold_vmapped(t: torch.Tensor, dim, n: int) -> torch.Tensor:
    """The LM kernels' ``vmap`` rules: move a vmapped dim of size ``n``
    (None: broadcast) to the front and merge it with the next one,
    (n, B, ...) -> (n * B, ...), a view where the strides allow it."""
    t = t.expand(n, *t.shape) if dim is None else t.movedim(dim, 0)
    return t.reshape(n * t.shape[1], *t.shape[2:])


class FlashAttention(torch.autograd.Function):
    """``FlashAttention.apply(q, k, v, causal, window)``: :func:`flash_attention`
    with a plain backward and a ``vmap`` rule (one launch a vmapped call)."""

    @staticmethod
    def forward(q, k, v, causal, window):
        return flash_attention(q, k, v, causal=causal, window=window)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window = inputs
        ctx.save_for_backward(q, k, v, output)
        ctx.causal, ctx.window = causal, window

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        return (*flash_attention_backward_plain(
            q, k, v, o, do, causal=ctx.causal, window=ctx.window), None, None)

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, window):
        n = info.batch_size
        q, k, v = (fold_vmapped(t, d, n) for t, d in zip((q, k, v), in_dims))
        out = FlashAttention.apply(q, k, v, causal, window)
        return out.reshape(n, -1, *out.shape[1:]), 0
