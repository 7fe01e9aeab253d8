"""Layered LM backbone for every family of the configs (port of
``repro.models.transformer``).

One :class:`~repro_torch.configs.base.ArchConfig` selects among:

* dense / vlm — pre-norm GQA transformer (optional QKV bias, full/half
  RoPE, optional sliding window), SwiGLU FFN; vlm prepends precomputed
  patch embeddings to the text;
* moe    — GQA or MLA attention + token-choice top-k MoE FFN
  (:mod:`repro_torch.models.moe`; optional shared experts, optional
  Arctic-style dense residual FFN);
* ssm    — Mamba2 SSD blocks (attention-free);
* hybrid — parallel attention + SSD heads per block (Hymba);
* audio  — encoder-decoder: a bidirectional encoder over precomputed frame
  embeddings, decoder blocks with cross-attention after self-attention.

Params are the reference's dict of leaves, the L blocks STACKED on a leading
axis, so they cross between the packages unchanged
(:func:`repro_torch.convert.params_from_jax`); the blocks run as a Python
loop over that axis. Computation is cast to ``cfg.dtype`` with float32
softmax, norms and SSM state; params stay in their stored dtype. On CUDA
tensors the full-sequence forward's GQA attention (causal self-attention,
the encoder's bidirectional self-attention, cross-attention) is the
hand-written flash attention kernel (``kernels/ops.py:gqa_flash``) and its
SSD scan the hand-written chunk-scan kernel (``ops.ssd_chunked_kernel``); on
CPU tensors both compute their plain versions. Both go through
``autograd.Function`` s with plain backwards, so :func:`loss_fn` trains
through the kernels under autograd and ``torch.func`` (the FL backends'
``vmap(grad)``). ``remat=True`` recomputes each block in the backward
(:class:`_Remat`), under autograd and ``torch.func`` alike. The decode path
is plain PyTorch, as in the reference, and updates its cache in place.
MLA (DeepSeek-V2) is plain PyTorch in both paths, as in the reference: its
q/k head dim (nope + rope, 192 at full width) is not the v head dim, which
the flash kernel does not take.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.attention import (decode_attention, mla_decode,
                                          mla_prefill, rope)
from repro_torch.models.moe import moe_ffn
from repro_torch.models.ssm import ssd_decode_step
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

PyTree = Any

__all__ = ["init_params", "forward", "loss_fn", "init_cache", "prefill",
           "decode_step", "build_cross_cache", "layer_ids", "count_params",
           "Cache", "check_supported", "token_nll", "with_moe_aux",
           "param_specs", "cache_specs"]

_F32 = torch.float32
_FAMILIES = ("dense", "moe", "hybrid", "ssm", "vlm", "audio")
# a stacked leaf whose f32 draw would take more than this is drawn one
# (a, b) matrix at a time: llava-next-34b's (60, 7168, 20480) FFN leaves
# are 35.2 GB in f32. Every earlier arch's leaves stay under it (the
# largest, command-r-35b's (40, 8192, 22528), is 29.5 GB), so they are
# drawn whole, as before
_WHOLE_DRAW_BYTES = 1 << 35


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for a family the configs do not name."""
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(f"{cfg.name}: family {cfg.family!r}")


def _dtype(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else getattr(torch, name)


# ---------------------------------------------------------------------------
# small helpers
# ---------------------------------------------------------------------------

def _rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.to(_F32)
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * g.to(x.dtype)


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype of the two, as jnp's matmul: the
    serve loop's f32 cache makes the decode's activations f32 while the
    weights are cast to the compute dtype."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def _swiglu(h, p, cdt):
    return _mm(F.silu(_mm(h, p["wg"].to(cdt))) * _mm(h, p["wu"].to(cdt)),
               p["wd"].to(cdt))


# ---------------------------------------------------------------------------
# parameter init (stacked over L)
# ---------------------------------------------------------------------------

class _Init:
    """Draws the params' leaves from ``gen`` on the generator's device and
    stores them on ``device`` in ``dtype`` (matrices) or f32 (norms, SSM
    scalars), with the reference's scales."""

    def __init__(self, gen: torch.Generator, dtype, device):
        self.gen, self.dtype, self.device = gen, dtype, device

    def normal(self, shape, scale, dtype=None) -> torch.Tensor:
        if self.device.type == "meta":       # shapes only: draw nothing
            return torch.empty(shape, dtype=dtype or self.dtype,
                               device=self.device)
        x = torch.randn(shape, generator=self.gen, device=self.gen.device)
        return x.mul_(scale).to(device=self.device, dtype=dtype or self.dtype)

    def dense(self, shape, scale=None) -> torch.Tensor:
        if 4 * math.prod(shape) > _WHOLE_DRAW_BYTES:
            return self.matrices(shape, scale)
        return self.normal(shape, 1.0 / math.sqrt(shape[-2])
                           if scale is None else scale)

    def matrices(self, shape, scale=None) -> torch.Tensor:
        """A stacked leaf (..., a, b) drawn one (a, b) matrix at a time into
        its storage: every expert leaf (at arctic-480b's width one f32 copy
        of a whole leaf of 2 blocks would be 35.7 GB) and a dense leaf past
        ``_WHOLE_DRAW_BYTES``."""
        scale = 1.0 / math.sqrt(shape[-2]) if scale is None else scale
        out = torch.empty(shape, dtype=self.dtype, device=self.device)
        if self.device.type != "meta":
            for mat in out.view(-1, *shape[-2:]):
                mat.copy_(torch.randn(shape[-2:], generator=self.gen,
                                      device=self.gen.device).mul_(scale))
        return out

    def full(self, shape, value, dtype=_F32) -> torch.Tensor:
        return torch.full(shape, value, dtype=dtype, device=self.device)


def _init_attn(init: _Init, cfg: ArchConfig, L: int) -> dict:
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    p = {"wq": init.dense((L, D, H * hd)),
         "wk": init.dense((L, D, KV * hd)),
         "wv": init.dense((L, D, KV * hd)),
         "wo": init.dense((L, H * hd, D), scale=1.0 / math.sqrt(H * hd))}
    if cfg.qkv_bias:
        for name, width in (("bq", H * hd), ("bk", KV * hd), ("bv", KV * hd)):
            p[name] = init.full((L, width), 0.0, init.dtype)
    return p


def _init_mlp(init: _Init, cfg: ArchConfig, L: int, d_ff=None) -> dict:
    D, Fd = cfg.d_model, d_ff or cfg.d_ff
    return {"wg": init.dense((L, D, Fd)), "wu": init.dense((L, D, Fd)),
            "wd": init.dense((L, Fd, D), scale=1.0 / math.sqrt(Fd))}


def _init_mla(init: _Init, cfg: ArchConfig, L: int) -> dict:
    D, H = cfg.d_model, cfg.n_heads
    dn, dr, dv, c = (cfg.mla_nope_dim, cfg.mla_rope_dim, cfg.mla_v_dim,
                     cfg.kv_lora)
    return {"wq": init.dense((L, D, H * (dn + dr))),
            "w_dkv": init.dense((L, D, c)),
            "w_uk": init.dense((L, c, H * dn)),
            "w_uv": init.dense((L, c, H * dv)),
            "w_kr": init.dense((L, D, dr)),
            "wo": init.dense((L, H * dv, D), scale=1.0 / math.sqrt(H * dv))}


def _init_moe(init: _Init, cfg: ArchConfig, L: int) -> dict:
    """Router (L, D, E) in f32 whatever the params' dtype; experts
    wg/wu (L, E, D, F) and wd (L, E, F, D)."""
    D, E, Fe = cfg.d_model, cfg.n_experts, cfg.expert_d_ff
    return {"router": init.normal((L, D, E), 1.0 / math.sqrt(D), _F32),
            "wg": init.matrices((L, E, D, Fe)),
            "wu": init.matrices((L, E, D, Fe)),
            "wd": init.matrices((L, E, Fe, D), scale=1.0 / math.sqrt(Fe))}


def _init_ssm(init: _Init, cfg: ArchConfig, L: int) -> dict:
    D, di, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_ch = di + 2 * N                   # conv over (x, b, c)
    return {
        "in_proj": init.dense((L, D, 2 * di + 2 * N + H)),   # z, x, b, c, dt
        "conv_w": init.normal((L, cfg.ssm_conv, conv_ch), 0.1),
        "conv_b": init.full((L, conv_ch), 0.0, init.dtype),
        "A_log": init.full((L, H), 0.0),                      # softplus -> ~0.69
        "skip_D": init.full((L, H), 1.0),
        "dt_bias": init.full((L, H), 0.0),
        "norm_g": init.full((L, di), 1.0),
        "out_proj": init.dense((L, di, D), scale=1.0 / math.sqrt(di)),
    }


def init_params(gen: torch.Generator, cfg: ArchConfig, *,
                dtype: torch.dtype | str = torch.float32,
                device=None) -> PyTree:
    """Full model params, blocks stacked over the leading L axis: the
    reference's structure, shapes and scales. Values are drawn from ``gen``
    on its own device (a CUDA generator for full width: drawing 1.6 B values
    on the CPU takes tens of seconds) and stored on ``device`` (the card
    unless the caller asks for another)."""
    check_supported(cfg)
    init = _Init(gen, _dtype(dtype), resolve_device(device))
    L, V, D = cfg.L, cfg.padded_vocab, cfg.d_model
    blocks: dict = {"norm1": init.full((L, D), 1.0)}
    if cfg.has_attention:
        blocks["attn"] = (_init_mla(init, cfg, L) if cfg.attention == "mla"
                          else _init_attn(init, cfg, L))
    if cfg.has_ssm:
        blocks["ssm"] = _init_ssm(init, cfg, L)
        if cfg.family == "hybrid":
            blocks["fuse_na"] = init.full((L, D), 1.0)
            blocks["fuse_ns"] = init.full((L, D), 1.0)
    if cfg.family != "ssm":
        blocks["norm2"] = init.full((L, D), 1.0)
    if cfg.is_moe:
        blocks["moe"] = _init_moe(init, cfg, L)
        if cfg.n_shared:
            blocks["shared"] = _init_mlp(init, cfg, L,
                                         d_ff=cfg.n_shared * cfg.expert_d_ff)
        if cfg.dense_residual:
            blocks["dense"] = _init_mlp(init, cfg, L)
    elif cfg.family != "ssm":
        blocks["mlp"] = _init_mlp(init, cfg, L)
    params = {"embed": init.normal((V, D), 0.02), "blocks": blocks,
              "final_norm": init.full((D,), 1.0)}
    if cfg.enc_layers:          # decoder cross-attention, then the encoder
        Le = cfg.enc_layers
        blocks["norm_x"] = init.full((L, D), 1.0)
        blocks["xattn"] = _init_attn(init, cfg, L)
        params["enc_blocks"] = {"norm1": init.full((Le, D), 1.0),
                                "attn": _init_attn(init, cfg, Le),
                                "norm2": init.full((Le, D), 1.0),
                                "mlp": _init_mlp(init, cfg, Le)}
        params["enc_norm"] = init.full((D,), 1.0)
    if not cfg.tie_embeddings:
        params["lm_head"] = init.normal((D, V), 0.02)
    return params


def count_params(params: PyTree) -> int:
    return sum(t.numel() for t in tree_leaves(params))


def _blocks(blocks: dict, L: int) -> list[dict]:
    """The L blocks' params, each a dict of views: every stacked leaf is
    unbound along its layer axis once. Its backward stacks the L layers'
    grads in one op, where indexing layer l of the stack would scatter
    each layer's grad into a zero tensor of the whole stack (L zero-filled
    stacks and L adds a leaf, in time and in memory)."""
    def unbind(tree):
        return ({k: unbind(v) for k, v in tree.items()}
                if isinstance(tree, dict) else tree.unbind(0))

    def pick(tree, l):
        return {k: pick(v, l) if isinstance(v, dict) else v[l]
                for k, v in tree.items()}

    views = unbind(blocks)
    return [pick(views, l) for l in range(L)]


def _embed(params: PyTree, tokens: torch.Tensor, cdt) -> torch.Tensor:
    """The token embeddings, through ``F.embedding``: its backward sums
    each row's grads in a fixed order. Indexing the table (``embed[tokens]``)
    has an ``index_put_(accumulate=True)`` backward, which on the CPU adds a
    repeated token's rows from several threads in whatever order they run,
    so two runs of one round differed in the last bits (ROADMAP 3.3)."""
    return F.embedding(tokens, params["embed"].to(cdt))


def _head(params: PyTree, cfg: ArchConfig, cdt) -> torch.Tensor:
    return (params["embed"].T if cfg.tie_embeddings
            else params["lm_head"]).to(cdt)


# ---------------------------------------------------------------------------
# block forward (full sequence: prefill)
# ---------------------------------------------------------------------------

def _proj(p, name: str, x, cdt, heads: int, hd: int):
    """``x @ w{name} (+ b{name})`` split into heads: (B, S, heads, hd)."""
    y = _mm(x, p["w" + name].to(cdt))
    if "b" + name in p:
        y = y + p["b" + name].to(cdt)
    return y.reshape(*x.shape[:2], heads, hd)


def _qkv(p, cfg: ArchConfig, h, cdt):
    H, KV, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    return (_proj(p, "q", h, cdt, H, hd), _proj(p, "k", h, cdt, KV, hd),
            _proj(p, "v", h, cdt, KV, hd))


def _cross_kv(p, cfg: ArchConfig, enc_out, cdt):
    """Cross-attention keys and values (B, S_enc, KV, hd) of the encoder
    output, without RoPE (as the reference)."""
    return (_proj(p, "k", enc_out, cdt, cfg.n_kv, cfg.head_dim),
            _proj(p, "v", enc_out, cdt, cfg.n_kv, cfg.head_dim))


def _attn_forward(p, cfg: ArchConfig, h, positions, cdt, *, causal=True,
                  kv_override=None):
    """GQA over the full sequence, h: (B, S, D): self-attention (causal, or
    bidirectional in the encoder), or cross-attention over the precomputed
    ``kv_override`` (never causal, q without RoPE)."""
    B, S, _ = h.shape
    if kv_override is None:
        q, k, v = _qkv(p, cfg, h, cdt)
        if cfg.rope_mode != "none":
            q = rope(q, positions, mode=cfg.rope_mode, theta=cfg.rope_theta)
            k = rope(k, positions, mode=cfg.rope_mode, theta=cfg.rope_theta)
    else:
        q = _proj(p, "q", h, cdt, cfg.n_heads, cfg.head_dim)
        k, v = kv_override
    out = ops.gqa_flash(q, k, v, causal=causal and kv_override is None,
                        window=cfg.window)
    return out.reshape(B, S, -1) @ p["wo"].to(cdt)


def _ssm_split(p, cfg: ArchConfig, h, cdt):
    """in_proj + split. h (B,S,D) -> z (B,S,di), xbc (B,S,di+2N), dt (B,S,H)."""
    di, N = cfg.d_inner, cfg.ssm_state
    zxbcdt = _mm(h, p["in_proj"].to(cdt))
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:2 * di + 2 * N]
    dt = F.softplus(zxbcdt[..., 2 * di + 2 * N:].to(_F32) + p["dt_bias"])
    return z, xbc, dt


def _ssm_forward(p, cfg: ArchConfig, h, cdt):
    """Mamba2 SSD mixer (full sequence). h: (B, S, D) -> (B, S, D)."""
    B, S, _ = h.shape
    di, N, Hs, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, xbc, dt = _ssm_split(p, cfg, h, cdt)
    # depthwise causal conv over the sequence (width cfg.ssm_conv), zeros
    # in front
    W = cfg.ssm_conv
    w = p["conv_w"].to(cdt)                                   # (W, C)
    pad = F.pad(xbc, (0, 0, W - 1, 0))
    conv = sum(pad[:, i:i + S, :] * w[i] for i in range(W))
    xbc = F.silu(conv + p["conv_b"].to(cdt))
    x = xbc[..., :di].reshape(B, S, Hs, P)
    b = xbc[..., di:di + N]
    c = xbc[..., di + N:]
    A = F.softplus(p["A_log"])
    Q = cfg.ssm_chunk
    padS = -S % Q                                             # to a chunk multiple
    xs, dts, bs, cs = x, dt, b, c
    if padS:
        xs = F.pad(x, (0, 0, 0, 0, 0, padS))
        dts = F.pad(dt, (0, 0, 0, padS))
        bs = F.pad(b, (0, 0, 0, padS))
        cs = F.pad(c, (0, 0, 0, padS))
    y = ops.ssd_chunked_kernel(xs, dts, A, bs, cs, chunk=Q)[:, :S]
    y = y + p["skip_D"].to(cdt)[None, None, :, None] * x
    y = y.reshape(B, S, di)
    y = _rms_norm(y * F.silu(z), p["norm_g"], cfg.norm_eps)
    return y @ p["out_proj"].to(cdt)


def _ffn_forward(p, cfg: ArchConfig, h, cdt, *, dropless: bool = False):
    """Dense SwiGLU, or MoE (+ shared / dense-residual). Returns (out, aux),
    aux None for a dense FFN.

    ``dropless`` (the decode path) sizes expert capacity so that no token
    is dropped (``capacity_factor = n_experts``), as in the reference.
    """
    if not cfg.is_moe:
        return _swiglu(h, p["mlp"], cdt), None
    B, S, D = h.shape
    moe_p = {k: v if k == "router" else v.to(cdt)
             for k, v in p["moe"].items()}
    cf = float(cfg.n_experts) if dropless else cfg.capacity_factor
    out, aux = moe_ffn(h.reshape(B * S, D), moe_p, top_k=cfg.top_k,
                       capacity_factor=cf)
    out = out.reshape(B, S, D)
    if cfg.n_shared:
        out = out + _swiglu(h, p["shared"], cdt)
    if cfg.dense_residual:
        out = out + _swiglu(h, p["dense"], cdt)
    return out, aux


def _block_forward(p, cfg: ArchConfig, h, positions, cdt, *, enc_out=None,
                   causal=True):
    """One block, full sequence: a decoder block (cross-attention over
    ``enc_out`` after self-attention when given) or, with ``causal=False``,
    an encoder block. Returns (h, aux), aux None for a block without MoE."""
    x = _rms_norm(h, p["norm1"], cfg.norm_eps)
    if cfg.family == "hybrid":
        a = _attn_forward(p["attn"], cfg, x, positions, cdt, causal=causal)
        s = _ssm_forward(p["ssm"], cfg, x, cdt)
        h = h + 0.5 * (_rms_norm(a, p["fuse_na"], cfg.norm_eps)
                       + _rms_norm(s, p["fuse_ns"], cfg.norm_eps))
    elif cfg.family == "ssm":
        # Mamba block: no FFN
        return h + _ssm_forward(p["ssm"], cfg, x, cdt), None
    elif cfg.attention == "mla":
        h = h + mla_prefill(x, {k: v.to(cdt) for k, v in p["attn"].items()},
                            cfg, positions)[0]
    else:
        h = h + _attn_forward(p["attn"], cfg, x, positions, cdt,
                              causal=causal)
    if enc_out is not None:
        xq = _rms_norm(h, p["norm_x"], cfg.norm_eps)
        h = h + _attn_forward(p["xattn"], cfg, xq, positions, cdt,
                              kv_override=_cross_kv(p["xattn"], cfg, enc_out,
                                                    cdt))
    out, aux = _ffn_forward(p, cfg, _rms_norm(h, p["norm2"], cfg.norm_eps),
                            cdt)
    return h + out, aux


class _Remat(torch.autograd.Function):
    """``_Remat.apply(fn, *args)`` is ``fn(*args)`` (a tuple of tensors)
    without keeping its activations: the forward runs ``fn`` under no grad
    and saves only its inputs; the backward re-runs it under
    ``torch.func.vjp`` and applies the cotangents. The reference's
    ``jax.checkpoint`` of a block. Its ``vmap`` rule is generated, so it
    runs under ``torch.func.vmap(torch.func.grad(...))`` (the nested flash
    and SSD Functions keep their own ``vmap`` rules, in the forward and in
    the recompute), and the same ops in the same order give the same
    values bit for bit as without it. The backward records the recompute
    whenever it runs with grad mode on, which is when a second derivative
    was asked for (``create_graph=True``, under autograd or any
    ``torch.func`` grad), so every second derivative through it is exact.
    The port's own first-order gradients (``repro_torch.autodiff.grad``)
    run their backward with grad mode off, so they record nothing."""

    generate_vmap_rule = True

    @staticmethod
    def forward(fn, *args):
        return fn(*args)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.fn = inputs[0]
        ctx.save_for_backward(*inputs[1:])

    @staticmethod
    def backward(ctx, *cotangents):
        # the vjp asks for a graph exactly when grad mode is on
        _, vjp = torch.func.vjp(ctx.fn, *ctx.saved_tensors)
        return (None, *vjp(cotangents))


def _run_block(p, cfg: ArchConfig, h, positions, cdt, *, enc_out=None,
               causal=True, remat=False):
    """:func:`_block_forward`, recomputed in the backward with ``remat``.
    The recompute takes the block's leaves as they come (views of the
    stacks, unbound once by :func:`_blocks`) and closes over ``cfg`` and
    ``cdt``, no tensor: a tensor made under the caller's ``torch.func``
    levels cannot enter the generated ``vmap`` rule's, so the positions are
    made again inside (the same ``arange``). It returns a zero aux for a
    block without MoE."""
    if not remat:
        return _block_forward(p, cfg, h, positions, cdt, enc_out=enc_out,
                              causal=causal)
    leaves = tree_leaves(p)
    n = len(leaves)

    def block(h, *rest):
        out, aux = _block_forward(
            tree_unflatten(p, list(rest[:n])), cfg, h,
            torch.arange(h.shape[1], device=h.device), cdt,
            enc_out=rest[n] if enc_out is not None else None, causal=causal)
        return out, (torch.zeros((), dtype=_F32, device=out.device)
                     if aux is None else aux)

    extra = () if enc_out is None else (enc_out,)
    return _Remat.apply(block, h, *leaves, *extra)


def _run_encoder(params: PyTree, cfg: ArchConfig, frames: torch.Tensor, cdt,
                 *, remat: bool = False) -> torch.Tensor:
    """The bidirectional encoder over frame embeddings (B, S_enc, D), then
    ``enc_norm``."""
    h = frames.to(cdt)
    positions = torch.arange(h.shape[1], device=h.device)
    for p in _blocks(params["enc_blocks"], cfg.enc_layers):
        h = _run_block(p, cfg, h, positions, cdt, causal=False,
                       remat=remat)[0]
    return _rms_norm(h, params["enc_norm"], cfg.norm_eps)


def forward(params: PyTree, cfg: ArchConfig, tokens: torch.Tensor, *,
            frontend: Optional[torch.Tensor] = None, remat: bool = False,
            with_aux: bool = False):
    """Logits (B, S_out, V) for a full sequence of tokens (B, S); with
    ``with_aux``, ``(logits, aux)`` as the reference returns them: aux is
    the blocks' summed MoE load-balance loss (f32; 0 without MoE).

    ``frontend`` (B, n_front, D): patch embeddings prepended to the text
    (vision: S_out = n_front + S) or frame embeddings the encoder reads
    (audio: S_out = S); ``None`` runs the text alone, as the reference.
    ``remat=True`` recomputes each block in the backward instead of keeping
    its activations (:class:`_Remat`, the reference's ``jax.checkpoint`` of
    the block; here the encoder's blocks too), under autograd and
    ``torch.func`` alike, and second derivatives through it."""
    check_supported(cfg)
    remat = remat and torch.is_grad_enabled()
    cdt = _dtype(cfg.dtype)
    h = _embed(params, tokens, cdt)
    enc_out = None
    if cfg.frontend == "vision" and frontend is not None:
        h = torch.cat([frontend.to(cdt), h], dim=1)
    elif cfg.frontend == "audio" and frontend is not None:
        enc_out = _run_encoder(params, cfg, frontend, cdt, remat=remat)
    positions = torch.arange(h.shape[1], device=h.device)
    aux = torch.zeros((), dtype=_F32, device=h.device)
    for p in _blocks(params["blocks"], cfg.L):
        # each decoder block reads the encoder output through an alias of
        # its own, so the encoder's grad sums block by block, in the order
        # the recomputed blocks (remat) hand theirs back
        h, a = _run_block(p, cfg, h, positions, cdt, remat=remat,
                          enc_out=None if enc_out is None
                          else enc_out.view_as(enc_out))
        if a is not None:
            aux = aux + a
    h = _rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = h @ _head(params, cfg, cdt)
    return (logits, aux) if with_aux else logits


def loss_fn(params: PyTree, cfg: ArchConfig, tokens: torch.Tensor,
            labels: torch.Tensor, *, frontend: Optional[torch.Tensor] = None,
            moe_aux_coef: float = 0.01, remat: bool = False) -> torch.Tensor:
    """Mean next-token CE over the text's (B, S) tokens and labels (a
    vision frontend's positions dropped), the log-softmax in f32, plus
    ``moe_aux_coef * aux / L`` when the config routes."""
    logits, aux = forward(params, cfg, tokens, frontend=frontend, remat=remat,
                          with_aux=True)
    if cfg.frontend == "vision" and frontend is not None:
        logits = logits[:, frontend.shape[1]:]
    return with_moe_aux(token_nll(logits, labels).mean(), aux, cfg,
                        moe_aux_coef)


def with_moe_aux(loss: torch.Tensor, aux: torch.Tensor, cfg: ArchConfig,
                 moe_aux_coef: float) -> torch.Tensor:
    """``loss + moe_aux_coef * aux / L`` for a config that routes, else
    ``loss``."""
    return loss + moe_aux_coef * aux / cfg.L if cfg.is_moe else loss


def token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-position next-token CE: ``-log_softmax(logits)[label]`` in f32."""
    logp = torch.log_softmax(logits.to(_F32), dim=-1)
    return -torch.gather(logp, -1, labels.long()[..., None])[..., 0]


def prefill(params: PyTree, cfg: ArchConfig, tokens: torch.Tensor, *,
            frontend: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Prefill: full-sequence forward returning last-position logits (B, V).

    (As in the reference, the serve loop fills its cache through
    :func:`decode_step`; the prefill is the batched forward's compute.)
    """
    return forward(params, cfg, tokens, frontend=frontend)[:, -1]


# ---------------------------------------------------------------------------
# KV / SSM / conv caches + decode
# ---------------------------------------------------------------------------

class Cache(NamedTuple):
    kv: Optional[tuple] = None        # (k, v): (L, B, W_or_S, KV, hd)
    mla: Optional[tuple] = None       # (c_kv (L,B,S,c), k_pe (L,B,S,dr))
    ssm: Optional[tuple] = None       # (state (L,B,H,N,P), conv (L,B,W-1,C))
    cross: Optional[tuple] = None     # (k, v): (L, B, S_enc, KV, hd)


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, *, dtype=None,
               device=None) -> Cache:
    """Zero caches. A sliding-window arch keeps a rolling window of
    W = min(window, max_seq) slots; MLA keeps the compressed latent and the
    shared rope key of every position; the SSM state is f32."""
    check_supported(cfg)
    dtype = _dtype(dtype or cfg.dtype)
    dev = resolve_device(device)
    L, KV, hd = cfg.L, cfg.n_kv, cfg.head_dim
    kv = mla = ssm = None
    if cfg.attention == "mla":
        mla = tuple(torch.zeros((L, batch, max_seq, width), dtype=dtype,
                                device=dev)
                    for width in (cfg.kv_lora, cfg.mla_rope_dim))
    elif cfg.has_attention:
        W = min(cfg.window, max_seq) if cfg.window else max_seq
        kv = tuple(torch.zeros((L, batch, W, KV, hd), dtype=dtype, device=dev)
                   for _ in range(2))
    if cfg.has_ssm:
        ssm = (torch.zeros((L, batch, cfg.ssm_heads, cfg.ssm_state,
                            cfg.ssm_head_dim), dtype=_F32, device=dev),
               torch.zeros((L, batch, cfg.ssm_conv - 1,
                            cfg.d_inner + 2 * cfg.ssm_state), dtype=dtype,
                           device=dev))
    return Cache(kv=kv, mla=mla, ssm=ssm)


def build_cross_cache(params: PyTree, cfg: ArchConfig,
                      enc_out: torch.Tensor) -> tuple:
    """Every decoder block's cross-attention keys and values of the encoder
    output, stacked: (k, v) each (L, B, S_enc, KV, hd), in the compute
    dtype; decode then never re-projects the encoder states."""
    cdt = _dtype(cfg.dtype)
    kvs = [_cross_kv(p["xattn"], cfg, enc_out, cdt)
           for p in _blocks(params["blocks"], cfg.L)]
    return tuple(torch.stack(t) for t in zip(*kvs))


def _attn_decode(p, cfg: ArchConfig, x, pos: int, k_c, v_c, cdt, *,
                 cross: bool = False):
    """Single-token GQA decode for one layer, x: (B, 1, D); writes this
    token's k, v into slot ``pos % W`` (rolling window) or ``pos`` of the
    layer's caches in place. ``cross``: attend over every slot of the
    cross cache (the encoder's positions), q without RoPE, writing
    nothing."""
    B = x.shape[0]
    if cross:
        q = _proj(p, "q", x, cdt, cfg.n_heads, cfg.head_dim)
        out = decode_attention(q, k_c, v_c, k_c.shape[1])
        return _mm(out.reshape(B, 1, -1), p["wo"].to(cdt))
    q, k, v = _qkv(p, cfg, x, cdt)
    if cfg.rope_mode != "none":
        pvec = torch.full((1,), pos, device=x.device)
        q = rope(q, pvec, mode=cfg.rope_mode, theta=cfg.rope_theta)
        k = rope(k, pvec, mode=cfg.rope_mode, theta=cfg.rope_theta)
    W = k_c.shape[1]
    slot = pos % W if cfg.window else min(pos, W - 1)
    k_c[:, slot] = k[:, 0]
    v_c[:, slot] = v[:, 0]
    out = decode_attention(q, k_c, v_c, min(pos + 1, W))
    return _mm(out.reshape(B, 1, -1), p["wo"].to(cdt))


def _mla_decode(p, cfg: ArchConfig, x, pos: int, c_c, pe_c, cdt):
    """Single-token MLA decode for one layer, x: (B, 1, D); writes this
    token's latent and rope key into slot ``pos`` of the layer's caches in
    place, then attends against the compressed cache."""
    ap = {k: v.to(cdt) for k, v in p.items()}
    c_c[:, pos] = _mm(x[:, 0], ap["w_dkv"])
    pe_c[:, pos] = rope(_mm(x, ap["w_kr"])[:, :, None, :],
                        torch.full((1,), pos, device=x.device), mode="full",
                        theta=cfg.rope_theta)[:, 0, 0]
    return mla_decode(x, ap, cfg, c_c, pe_c, pos)


def _ssm_decode(p, cfg: ArchConfig, x, state, conv_hist, cdt):
    """Single-token SSD decode for one layer, x: (B, 1, D). Updates the
    layer's state (B,H,N,P) and conv history (B,W-1,C) in place."""
    B = x.shape[0]
    di, N, Hs, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, xbc, dt = _ssm_split(p, cfg, x, cdt)                   # (B,1,·)
    seq = torch.cat([conv_hist, xbc], dim=1)                 # (B, W, C)
    w = p["conv_w"].to(cdt)
    wdt = torch.promote_types(seq.dtype, cdt)
    conv = (torch.einsum("bwc,wc->bc", seq.to(wdt), w.to(wdt))
            + p["conv_b"].to(cdt))
    xbc1 = F.silu(conv)
    xh = xbc1[:, :di].reshape(B, Hs, P)
    b = xbc1[:, di:di + N]
    c = xbc1[:, di + N:]
    A = F.softplus(p["A_log"])
    y, new_state = ssd_decode_step(xh, dt[:, 0], A, b, c, state)
    state.copy_(new_state)
    conv_hist.copy_(seq[:, 1:])
    y = y + p["skip_D"].to(cdt)[None, :, None] * xh
    y = y.reshape(B, di)
    y = _rms_norm(y * F.silu(z[:, 0]), p["norm_g"], cfg.norm_eps)
    return _mm(y, p["out_proj"].to(cdt))[:, None, :]


def decode_step(params: PyTree, cfg: ArchConfig, cache: Cache,
                token: torch.Tensor, pos: int):
    """One decode step. token: (B,) int; pos: the absolute position (int).
    With ``cache.cross`` (:func:`build_cross_cache`) each decoder block
    attends over the encoder output after self-attention.

    Returns (logits (B, V) f32, cache); the cache is updated in place.
    """
    check_supported(cfg)
    cdt = _dtype(cfg.dtype)
    pos = int(pos)
    h = _embed(params, token, cdt)[:, None, :]                # (B, 1, D)
    for l, p in enumerate(_blocks(params["blocks"], cfg.L)):
        x = _rms_norm(h, p["norm1"], cfg.norm_eps)
        if cfg.attention == "mla":
            a = _mla_decode(p["attn"], cfg, x, pos, cache.mla[0][l],
                            cache.mla[1][l], cdt)
        elif cfg.has_attention:
            a = _attn_decode(p["attn"], cfg, x, pos, cache.kv[0][l],
                             cache.kv[1][l], cdt)
        if cfg.has_ssm:
            s = _ssm_decode(p["ssm"], cfg, x, cache.ssm[0][l],
                            cache.ssm[1][l], cdt)
        if cfg.family == "hybrid":
            h = h + 0.5 * (_rms_norm(a, p["fuse_na"], cfg.norm_eps)
                           + _rms_norm(s, p["fuse_ns"], cfg.norm_eps))
        elif cfg.family == "ssm":
            h = h + s
            continue
        else:
            h = h + a
        if cache.cross is not None:
            h = h + _attn_decode(p["xattn"], cfg,
                                 _rms_norm(h, p["norm_x"], cfg.norm_eps), pos,
                                 cache.cross[0][l], cache.cross[1][l], cdt,
                                 cross=True)
        h = h + _ffn_forward(p, cfg, _rms_norm(h, p["norm2"], cfg.norm_eps),
                             cdt, dropless=True)[0]
    h = _rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = _mm(h[:, 0], _head(params, cfg, cdt)).to(_F32)
    return logits, cache


# ---------------------------------------------------------------------------
# ADEL layer ids + sharding specs
# ---------------------------------------------------------------------------

def layer_ids(params: PyTree, cfg: ArchConfig) -> PyTree:
    """Pytree congruent with params mapping leaves to ADEL mask layers.

    Blocks get their stacked index, decoder blocks offset by ``enc_layers``
    (backprop reaches the decoder first, so the encoder is deeper: lower
    ids); the embedding joins layer 0 (reached last); final norm, encoder
    norm and head join the last layer (reached first).
    """
    last = cfg.n_blocks_total - 1
    ids: dict = {}
    for k, v in params.items():
        if k in ("blocks", "enc_blocks"):
            n, first = ((cfg.L, cfg.enc_layers) if k == "blocks"
                        else (cfg.enc_layers, 0))
            ids[k] = tree_map(lambda t: torch.arange(
                first, first + n, dtype=torch.int32, device=t.device), v)
        elif k == "embed":
            ids[k] = 0
        else:  # final_norm, enc_norm, lm_head
            ids[k] = last
    return ids


def param_specs(params: PyTree, cfg: ArchConfig, *, fsdp="data",
                tp: str = "model") -> PyTree:
    """Partition-spec tree (:class:`repro_torch.launch.mesh.PartitionSpec`):
    2D (fsdp x tensor) sharding, the reference's rules by leaf name and
    rank.

    Big matrices shard their input dim over ``fsdp`` (the data axis, ZeRO-3
    style) and their output/feature dim over ``tp``. Vectors and norms
    replicate. The stacked L axis is NEVER sharded (ADEL masks index it).
    """
    from repro_torch.launch.mesh import PartitionSpec as P

    def spec(name: str, leaf) -> P:
        nd = leaf.dim()
        if name == "embed":
            return P(tp, fsdp)
        if name == "lm_head":
            return P(fsdp, tp)
        if name == "router":
            return P(None, fsdp, None)
        if name in ("wg", "wu") and nd == 4:          # experts (L, E, D, F)
            return P(None, fsdp, None, tp)
        if name == "wd" and nd == 4:                  # (L, E, F, D)
            return P(None, fsdp, tp, None)
        if name in ("wq", "wk", "wv", "wg", "wu", "w_dkv", "w_uk", "w_uv",
                    "w_kr", "in_proj") and nd == 3:   # (L, D, F)
            return P(None, fsdp, tp)
        if name in ("wo", "wd", "out_proj") and nd == 3:  # (L, F, D)
            return P(None, tp, fsdp)
        if name in ("bq", "bk", "bv") and nd == 2:    # (L, F)
            return P(None, tp)
        return P(*([None] * nd))                      # norms, scalars, conv

    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return spec(name, tree)

    return walk(params)


def cache_specs(cache: Cache, cfg: ArchConfig, *, batch="data", tp="model"):
    """Cache sharding: batch over the data axes, head_dim over ``tp`` for KV
    caches (decode attention reduces over tp); the MLA latent dim over
    ``tp``; the SSM state's heads over ``tp``."""
    from repro_torch.launch.mesh import PartitionSpec as P

    def kv_spec(x):
        return P(None, batch, None, None, tp)         # (L,B,S,KV,hd)

    kv = None if cache.kv is None else tuple(kv_spec(x) for x in cache.kv)
    mla = None if cache.mla is None else (
        P(None, batch, None, tp), P(None, batch, None, None))
    ssm = None if cache.ssm is None else (
        P(None, batch, tp, None, None), P(None, batch, None, tp))
    cross = None if cache.cross is None else tuple(
        kv_spec(x) for x in cache.cross)
    return Cache(kv=kv, mla=mla, ssm=ssm, cross=cross)
