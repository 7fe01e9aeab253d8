"""Mixture-of-Experts FFN with token-choice top-k routing, fixed expert
capacity and the Switch load-balance auxiliary loss (port of
``repro.models.moe``).

Dispatch keeps the reference's compact form: each assignment is positioned
within its expert by a cumulative sum over the flattened (token-major,
k-minor) assignments, those at position >= C are dropped, and the rest are
written into an (E, C, D) buffer, multiplied per expert as batched products
and combined back with the router weights.

Every op has a ``torch.func.vmap`` rule (the FL backends take
``vmap(grad)`` over clients, so ``N`` is one client's tokens) and a backward
that sums in a fixed order: the one-hot is a comparison with ``arange(E)``,
the dispatch an out-of-place ``index_put`` whose kept slots are distinct
(dropped assignments go to a spare row that is cut off), the combine a sum
over the K assignments of a token. There is no kernel here: the reference
computes its experts outside any Pallas kernel.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

__all__ = ["expert_positions", "moe_ffn", "router_topk"]

_F32 = torch.float32


@contextlib.contextmanager
def _full_f32(device: torch.device):
    """Matmuls in full f32 on the card for the router's product: TF32 would
    round the logits, and a one-token routing flip moves every later
    position in its expert (and so the dropped set)."""
    flag = torch.backends.cuda.matmul
    if device.type != "cuda" or not flag.allow_tf32:
        yield
        return
    flag.allow_tf32 = False
    try:
        yield
    finally:
        flag.allow_tf32 = True


def _onehot(idx: torch.Tensor, E: int, dtype) -> torch.Tensor:
    """``idx[..., None] == arange(E)`` in ``dtype`` (``F.one_hot`` has no
    vmap rule)."""
    return (idx[..., None] == torch.arange(E, device=idx.device)).to(dtype)


def router_topk(x2d: torch.Tensor, w_router: torch.Tensor, top_k: int):
    """Token-choice routing. x2d: (N, D) -> (weights (N, K) f32, experts
    (N, K), aux).

    Logits in f32, softmax, top-k, weights renormalized by
    ``max(sum, 1e-9)``; aux is the Switch load-balance loss
    ``E * sum_e f_e * p_e``.
    """
    with _full_f32(x2d.device):
        logits = x2d.to(_F32) @ w_router.to(_F32)                  # (N, E)
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, top_k, dim=-1)                      # (N, K)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    E = w_router.shape[1]
    f = _onehot(idx, E, _F32).sum((0, 1)) / idx.numel()
    aux = E * torch.sum(f * probs.mean(0))
    return w, idx, aux


def expert_positions(flat_e: torch.Tensor, E: int, C: int) -> tuple:
    """Each assignment's position within its expert, in the flattened
    (token-major, k-minor) order of ``flat_e`` (N*K,), and the keep mask
    ``pos < C`` (False: dropped at capacity).

    The running count of each expert's assignments is a scan along the
    last dim of an (E, N*K) one-hot: on the card a scan along the first
    dim of the (N*K, E) one-hot runs each expert's column serially (27
    such scans were 40% of a deepseek-v2-lite-16b prefill)."""
    hits = (torch.arange(E, device=flat_e.device)[:, None]
            == flat_e[None, :]).to(torch.int32)                   # (E, N*K)
    count = torch.cumsum(hits, dim=1, dtype=torch.int32)
    pos = torch.gather(count, 0, flat_e[None, :].long())[0] - 1
    return pos, pos < C


def moe_ffn(x2d: torch.Tensor, p: dict, *, top_k: int,
            capacity_factor: float = 1.25, activation=F.silu):
    """x2d: (N, D). Params p: router (D, E), wg/wu (E, D, F), wd (E, F, D).

    Returns (out (N, D) in x2d's dtype, aux scalar). Capacity
    ``C = max(int(N * K * capacity_factor / E), 1)`` a call.
    """
    N, D = x2d.shape
    E = p["router"].shape[1]
    K = top_k
    C = max(int(N * K * capacity_factor / E), 1)

    weights, experts, aux = router_topk(x2d, p["router"], K)       # (N, K)

    flat_e = experts.reshape(-1)                                   # (N*K,)
    pos, keep = expert_positions(flat_e, E, C)
    spare = E * C
    slot = torch.where(keep, flat_e * C + pos, torch.full_like(pos, spare))

    # dispatch: the kept assignments' tokens into an (E*C + 1, D) buffer
    dt = torch.promote_types(x2d.dtype, p["wg"].dtype)
    src = x2d.to(dt)[:, None, :].expand(N, K, D).reshape(N * K, D)
    buf = torch.zeros((spare + 1, D), dtype=dt, device=x2d.device)
    buf = buf.index_put((slot,), src)[:spare].reshape(E, C, D)

    # expert computation (SwiGLU) as batched products
    g = torch.bmm(buf, p["wg"].to(dt))
    u = torch.bmm(buf, p["wu"].to(dt))
    y = torch.bmm(activation(g) * u, p["wd"].to(dt)).reshape(spare, D)

    # combine: each assignment's expert output (the spare row reads zeros),
    # weighted, summed over the token's K assignments
    y = torch.cat([y, y.new_zeros((1, D))])
    gathered = y.index_select(0, slot).reshape(N, K, D)
    out = (gathered * weights.to(dt)[..., None]).sum(1)
    return out.to(x2d.dtype), aux
