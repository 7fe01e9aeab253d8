"""Mamba2 SSD chunk scan: a hand-written CUDA kernel for Hopper
(``csrc/ssd_scan.cu``) and its plain PyTorch version.

:func:`ssd_scan` replaces ``repro/kernels/ssd_scan.py:ssd_scan``: inputs
pre-scaled by the caller, ``xdt = x * dt`` and ``la = -A * dt``, with ``b``
and ``c`` (G, S, N) read per group: head ``bh`` uses row ``bh // (BH // G)``.
The model passes its per-batch projections (G = B), so nothing is copied out
per head; ``G = BH`` is the reference's per-head layout. ``xdt`` is (BH, S,
P) or (G, r, S, P), ``la`` (BH, S) or (G, r, S), read through their strides
(:func:`scan_strides`): ``ops.ssd_chunked_kernel`` hands over (B, H, S, P)
and (B, H, S) views of the model's (B, S, H, P) and (B, S, H) tensors and
gets y back in (B, S, H, P) memory with no copy. Per chunk of Q = min(chunk,
S) tokens it forms the within-chunk dual term and passes an f32 (N, P)
state from chunk to chunk; y (like xdt, same strides) f32. ``S % Q == 0``
is the caller's job, as in the reference.

On the card one call is one kernel launch (``ssd_scan_tc``, or
``ssd_scan_ws`` with a producer warpgroup; the source's header has the
design and the bound): a block walks a head's chunks in order, ``TILE``
tokens at a time, with its state in f32 registers, every product on the
tensor cores as three TF32 products (3xTF32); it needs no scratch. The
tile is ``TILE`` tokens whatever ``chunk`` is: the chunked form is exact
for any chunk length, so the chunk only sets the refusal of an S that is
not a multiple of it.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor
it computes :func:`ssd_scan_plain` (the chunked SSD algorithm of
``models/ssm.py``, in f32), which ``chip_smoke.py`` also holds the kernel
against on the card. On a ``meta`` tensor (the dry run,
``launch/dryrun.py``) it takes the plain version's shapes and computes
nothing; the within-chunk term is counted as the full Q x Q product, as
the reference's count of its jnp ``ssd_chunked`` does. ``ssd_scan.launches``
counts the calls that launched the kernel (one per call).

:class:`SSDScan` is the wrapper under autograd and ``torch.func``: its
forward is :func:`ssd_scan` (the kernel on the card), its backward the
vector-Jacobian product of :func:`ssd_scan_plain` (the reference has no
backward kernel), and its ``vmap`` rule folds the vmapped dim into the
groups, so one call serves every client of a vmapped call.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels.build import PLAIN_DEVICES, load_library
from repro_torch.kernels.flash_attention import fold_vmapped
from repro_torch.models.ssm import chunk_scan

__all__ = ["ssd_scan", "ssd_scan_plain", "scan_strides", "kernel_plan",
           "SSDScan", "TILE"]

_LIB = "ssd_scan"
_INVALID_VALUE = 1            # cudaErrorInvalidValue
# tokens a tile of the kernel (``kT`` in ``csrc/ssd_scan.cu``; the CPU
# emulation of its schedule walks the same tiles)
TILE = 64


def _shapes(xdt, b, chunk: int) -> tuple:
    *lead, S, P = xdt.shape
    G, _, N = b.shape
    return math.prod(lead), G, S, P, N, min(chunk, S)


def ssd_scan_plain(xdt: torch.Tensor, la: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, *, chunk: int = 64) -> torch.Tensor:
    """Plain PyTorch SSD chunk scan, the kernel's reference: y of xdt's
    shape and dtype, computed in f32."""
    BH, G, S, P, N, Q = _shapes(xdt, b, chunk)
    r = BH // G
    y, _ = chunk_scan(xdt.reshape(G, r, S, P), la.reshape(G, r, S), b, c,
                      chunk=Q)
    return y.reshape(xdt.shape).to(xdt.dtype)


def scan_strides(t: torch.Tensor, G: int, *, features: bool) -> tuple:
    """Element strides (group, head, token) by which the kernels step
    through ``xdt`` (``features``: (BH, S, P) or (G, r, S, P), P
    unit-stride) or ``la`` ((BH, S) or (G, r, S)). A single leading dim BH
    is split into G groups of r = BH // G heads."""
    lead = t.dim() - (2 if features else 1)
    if lead not in (1, 2):
        raise ValueError(f"{tuple(t.shape)} is not ({'BH' if lead < 2 else 'G, r'}"
                         f", S{', P' if features else ''})")
    if features and t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"the P dim of {tuple(t.shape)} needs unit stride, "
                         f"not {t.stride(-1)}")
    if lead == 2:
        return t.stride(0), t.stride(1), t.stride(2)
    return (t.shape[0] // G) * t.stride(0), t.stride(0), t.stride(1)


@functools.lru_cache(maxsize=None)
def _kernels():
    lib = load_library(_LIB)
    ll, vp, i = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
    fn = lib.ssd_scan_f32
    fn.argtypes = ([vp, ll, ll, ll, vp, ll, ll, ll, vp, vp, vp, ll, ll, ll]
                   + [i] * 6 + [vp])
    fn.restype = i
    plan = lib.ssd_scan_plan
    plan.argtypes = [i] * 5 + [ctypes.POINTER(i)]
    plan.restype = i
    return fn, plan


def kernel_plan(G: int, r: int, S: int, P: int, N: int) -> dict:
    """The built library's plan for a call (needs the CUDA toolkit): P
    columns a block (``pw``), ``slices`` of P, ring ``stages``, warpgroups
    a block (``groups``: 2 is a producer warpgroup beside the consumer for
    a small state, two warpgroups sharing each tile for N over 64),
    shared ``bytes`` a block."""
    plan = _kernels()[1]
    out = (ctypes.c_int * 5)()
    if plan(G, r, S, P, N, out) != 0:
        raise ValueError(f"no SSD plan fits P {P}, N {N}")
    return dict(zip(("pw", "slices", "stages", "groups", "bytes"), out))


def _check(xdt, la, b, c, chunk: int) -> tuple:
    if (xdt.dim() not in (3, 4) or la.dim() != xdt.dim() - 1 or b.dim() != 3
            or c.shape != b.shape):
        raise ValueError(f"expected xdt (BH, S, P) or (G, r, S, P), la of its "
                         f"shape less P, b, c (G, S, N); got "
                         f"{tuple(xdt.shape)}, {tuple(la.shape)}, "
                         f"{tuple(b.shape)}, {tuple(c.shape)}")
    BH, G, S, P, N, Q = _shapes(xdt, b, chunk)
    if (la.shape != xdt.shape[:-1] or b.shape[1] != S or G < 1 or BH % G
            or (xdt.dim() == 4 and xdt.shape[0] != G)):
        raise ValueError(f"la {tuple(la.shape)} / b {tuple(b.shape)} do not "
                         f"match xdt {tuple(xdt.shape)} (BH % G == 0)")
    if Q < 1 or S % Q:
        raise ValueError(f"S = {S} is not a multiple of the chunk {Q}; the "
                         "caller pads")
    for t in (xdt, la, b, c):
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_scan takes float32 inputs, got {t.dtype}")
        if t.device != xdt.device:
            raise ValueError(f"inputs on {t.device} and {xdt.device}")
    if not (b.is_contiguous() and c.is_contiguous()):
        raise ValueError("ssd_scan's b and c must be contiguous")
    return BH, G, S, P, N, Q


def ssd_scan(xdt: torch.Tensor, la: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, *, chunk: int = 64) -> torch.Tensor:
    """xdt (BH, S, P) or (G, r, S, P), la (BH, S) or (G, r, S), b, c (G, S,
    N), all f32 -> y f32 of xdt's shape and strides."""
    if xdt.device.type in PLAIN_DEVICES:
        return ssd_scan_plain(xdt, la, b, c, chunk=chunk)
    if xdt.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on CUDA, CPU or meta, not {xdt.device}")
    BH, G, S, P, N, Q = _check(xdt, la, b, c, chunk)
    xs = scan_strides(xdt, G, features=True)
    ls = scan_strides(la, G, features=False)
    fn = _kernels()[0]
    with torch.cuda.device(xdt.device):
        y = torch.empty_like(xdt)          # dense inputs keep their strides
        ys = scan_strides(y, G, features=True)
        err = fn(xdt.data_ptr(), *xs, la.data_ptr(), *ls, b.data_ptr(),
                 c.data_ptr(), y.data_ptr(), *ys, G, BH // G, S, P, N, Q,
                 torch.cuda.current_stream().cuda_stream)
    if err == _INVALID_VALUE:   # the sizes passed _check; the tiles do not fit
        raise ValueError(f"chunk {Q}, P {P}, N {N} need more shared memory "
                         "than a block may have")
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: error {err}")
    ssd_scan.launches += 1
    return y


ssd_scan.launches = 0


class SSDScan(torch.autograd.Function):
    """``SSDScan.apply(xdt, la, b, c, chunk)``: :func:`ssd_scan` with the
    plain version's vector-Jacobian product as backward and a ``vmap`` rule
    (one launch a vmapped call)."""

    @staticmethod
    def forward(xdt, la, b, c, chunk):
        return ssd_scan(xdt, la, b, c, chunk=chunk)

    @staticmethod
    def setup_context(ctx, inputs, output):
        xdt, la, b, c, chunk = inputs
        ctx.save_for_backward(xdt, la, b, c)
        ctx.chunk = chunk

    @staticmethod
    def backward(ctx, dy):
        chunk = ctx.chunk
        _, vjp = torch.func.vjp(
            lambda *a: ssd_scan_plain(*a, chunk=chunk), *ctx.saved_tensors)
        return (*vjp(dy), None)

    @staticmethod
    def vmap(info, in_dims, xdt, la, b, c, chunk):
        # client i's group g becomes group i * G + g; its heads keep it
        n = info.batch_size
        xdt, la = fold_vmapped(xdt, in_dims[0], n), fold_vmapped(
            la, in_dims[1], n)
        b, c = (fold_vmapped(t, d, n).contiguous()
                for t, d in zip((b, c), in_dims[2:4]))
        y = SSDScan.apply(xdt, la, b, c, chunk)
        return y.reshape(n, -1, *y.shape[1:]), 0
