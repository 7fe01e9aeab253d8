"""Attention primitives: GQA (optionally sliding-window), RoPE (full / half
"2d" ChatGLM-style), single-token decode against a full or rolling-window
KV cache, and MLA (DeepSeek-V2 multi-head latent attention) with a
compressed KV cache (port of ``repro.models.attention``).

All functions are plain PyTorch. The model's GQA prefill calls the CUDA
flash attention kernel through ``kernels/ops.py:gqa_flash``;
:func:`gqa_attention` is the reference's jnp attention, kept for the parity
tests. MLA's prefill stays plain, as in the reference: its q/k head dim
(nope + rope) is not its v head dim.
"""
from __future__ import annotations

import torch

__all__ = ["rope", "visible_mask", "gqa_attention", "decode_attention",
           "mla_prefill", "mla_decode"]

_F32 = torch.float32


def _rope_angles(positions: torch.Tensor, dim: int, theta: float) -> tuple:
    """positions (...,) -> (cos, sin) of shape (..., dim//2), float32."""
    exps = torch.arange(0, dim, 2, dtype=_F32, device=positions.device) / dim
    inv = 1.0 / (theta ** exps)
    ang = positions.to(_F32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def rope(x: torch.Tensor, positions: torch.Tensor, *, mode: str = "full",
         theta: float = 10000.0) -> torch.Tensor:
    """Apply rotary embedding. x: (B, S, H, hd); positions: (B, S) or (S,).

    mode: "full" rotates the whole head dim; "half" (ChatGLM 2d-RoPE style)
    rotates only the first half and passes the rest through; "none" is id.
    """
    if mode == "none":
        return x
    hd = x.shape[-1]
    rot = hd if mode == "full" else hd // 2
    xr, xp = x[..., :rot], x[..., rot:]
    cos, sin = _rope_angles(positions, rot, theta)          # (B, S, rot/2)
    cos = cos[..., None, :].to(x.dtype)                     # (B, S, 1, rot/2)
    sin = sin[..., None, :].to(x.dtype)
    x1, x2 = xr.chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out, xp], dim=-1) if rot < hd else out


def visible_mask(Sq: int, Sk: int, causal: bool, window: int,
                 device="cpu", q_pos0: int = 0) -> torch.Tensor:
    """(Sq, Sk) bool: key j is visible to query i, whose absolute position
    is ``q_pos0 + i`` (keys from 0)."""
    qpos = q_pos0 + torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    return mask


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  q_pos0: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd); H = KV * G. Returns (B, Sq, H, hd).

    ``window`` > 0 restricts attention to the last ``window`` keys
    (sliding-window attention). ``q_pos0`` is the absolute position of the
    first query. Probabilities are cast to v's dtype before the PV product,
    as in the reference.
    """
    B, Sq, H, hd = q.shape
    KV, Sk = k.shape[2], k.shape[1]
    G = H // KV
    qr = q.reshape(B, Sq, KV, G, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qr.to(_F32),
                          k.to(_F32)) * hd ** -0.5          # (B,KV,G,Sq,Sk)
    mask = visible_mask(Sq, Sk, causal, window, q.device, q_pos0)
    scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype), v)
    return out.reshape(B, Sq, H, hd)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, n_valid: int) -> torch.Tensor:
    """Single-token decode. q: (B, 1, H, hd); caches: (B, S, KV, hd).

    ``n_valid``: number of valid cache slots (the first ``n_valid``). A
    rolling-window cache is full once the window has filled, and attention
    does not depend on the order of the slots, so the same mask serves it.
    """
    B, _, H, hd = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    qr = q.reshape(B, KV, G, hd)
    scores = torch.einsum("bkgd,btkd->bkgt", qr.to(_F32),
                          k_cache.to(_F32)) * hd ** -0.5     # (B,KV,G,S)
    valid = torch.arange(k_cache.shape[1], device=q.device) < n_valid
    scores = scores.masked_fill(~valid, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", probs.to(v_cache.dtype), v_cache)
    return out.reshape(B, 1, H, hd)


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention, DeepSeek-V2): compressed KV cache
# ---------------------------------------------------------------------------

def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype of the two, as jnp's matmul."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def _mla_dims(cfg) -> tuple:
    return (cfg.n_heads, cfg.mla_nope_dim, cfg.mla_rope_dim, cfg.mla_v_dim,
            cfg.kv_lora)


def mla_prefill(x: torch.Tensor, p: dict, cfg, positions: torch.Tensor):
    """Prefill/train MLA. x: (B, S, D). Returns (attn_out (B, S, D),
    (c_kv (B, S, c), k_pe (B, S, dr))).

    Params p: wq (D, H*(dn+dr)), w_dkv (D, c), w_uk (c, H*dn),
    w_uv (c, H*dv), w_kr (D, dr), wo (H*dv, D). Scores in f32 over
    ``q_nope . k_nope + q_pe . k_pe``, scaled by ``(dn + dr) ** -0.5``,
    causal (masked at -1e30).
    """
    B, S, _ = x.shape
    H, dn, dr, dv, _ = _mla_dims(cfg)
    q = _mm(x, p["wq"]).reshape(B, S, H, dn + dr)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    q_pe = rope(q_pe, positions, mode="full", theta=cfg.rope_theta)
    c_kv = _mm(x, p["w_dkv"])                                 # (B, S, c)
    k_pe = rope(_mm(x, p["w_kr"])[:, :, None, :], positions, mode="full",
                theta=cfg.rope_theta)[:, :, 0]                # (B, S, dr)
    k_nope = _mm(c_kv, p["w_uk"]).reshape(B, S, H, dn)
    v = _mm(c_kv, p["w_uv"]).reshape(B, S, H, dv)
    scores = (torch.einsum("bshd,bthd->bhst", q_nope.to(_F32),
                           k_nope.to(_F32))
              + torch.einsum("bshd,btd->bhst", q_pe.to(_F32),
                             k_pe.to(_F32))) * (dn + dr) ** -0.5
    mask = visible_mask(S, S, True, 0, x.device)
    probs = torch.softmax(scores.masked_fill(~mask, -1e30), dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs.to(v.dtype), v)
    return _mm(out.reshape(B, S, H * dv), p["wo"]), (c_kv, k_pe)


def mla_decode(x: torch.Tensor, p: dict, cfg, c_cache: torch.Tensor,
               kpe_cache: torch.Tensor, pos: int) -> torch.Tensor:
    """Absorbed-matrix MLA decode: scores against the COMPRESSED cache
    (c_kv, k_pe) without re-expanding K/V, in f32. x: (B, 1, D);
    c_cache: (B, S, c); kpe_cache: (B, S, dr); the first ``pos + 1`` slots
    are valid. Returns (B, 1, D)."""
    B = x.shape[0]
    H, dn, dr, dv, c = _mla_dims(cfg)
    q = _mm(x, p["wq"]).reshape(B, 1, H, dn + dr)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    q_pe = rope(q_pe, torch.full((1,), pos, device=x.device), mode="full",
                theta=cfg.rope_theta)
    # absorb W_uk into the query: q_c (B, H, c)
    q_c = torch.einsum("bhd,chd->bhc", q_nope[:, 0].to(_F32),
                       p["w_uk"].reshape(c, H, dn).to(_F32))
    scores = (torch.einsum("bhc,btc->bht", q_c, c_cache.to(_F32))
              + torch.einsum("bhd,btd->bht", q_pe[:, 0].to(_F32),
                             kpe_cache.to(_F32))) * (dn + dr) ** -0.5
    valid = torch.arange(c_cache.shape[1], device=x.device) < pos + 1
    probs = torch.softmax(scores.masked_fill(~valid, -1e30), dim=-1)
    # attend in latent space, then expand through W_uv (absorbed output)
    ctx_c = torch.einsum("bht,btc->bhc", probs, c_cache.to(_F32))
    ctx = torch.einsum("bhc,chd->bhd", ctx_c,
                       p["w_uv"].reshape(c, H, dv).to(_F32))
    return _mm(ctx.reshape(B, 1, H * dv).to(x.dtype), p["wo"])
