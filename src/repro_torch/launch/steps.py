"""Step functions of the LM path (port of ``repro.launch.steps``).

``make_train_step`` is ONE FEDERATED ROUND of ADEL-FL for an LM: per-client
gradients -> the Eq. 5 coefficients from the per-(client, layer) straggler
mask -> the bias-corrected layer-wise fold (gradient form) -> the server
SGD update ``w - eta * fold(c, g)``, in f32 and cast back to the params'
dtype. Every fold goes through the hand-written grouped kernel
(``adel_agg_grouped`` via :func:`repro_torch.kernels.ops.fold_tree`).

Two client layouts:

* ``temporal`` (default) — clients are grad-accumulation microbatches:
  one client's gradient at a time (``torch.autograd.grad``), folded with
  its coefficient row into an f32 accumulator, so peak memory is one
  gradient pytree whatever U (one fold launch a client).
* ``spatial`` — ``torch.func.vmap`` of a client's gradient over the client
  axis (:func:`repro_torch.autodiff.grad`: ``torch.func.grad``'s values,
  the backward recorded only when something can differentiate it) and one
  fold launch for the round.

``remat=True`` (the default, as the reference's) recomputes each block in
the backward in both layouts (``models/transformer.py:_Remat``).

:func:`make_prefill_step` and :func:`make_serve_step` run the LM forward
for inference (``torch.inference_mode``).

A config with a frontend (vlm, audio) makes :func:`make_train_step`,
:func:`make_client_grad` and :func:`make_prefill_step` take a trailing
``frontend`` argument, as the reference's do: patch or frame embeddings
(U, b, n_front, D), (b, n_front, D) and (B, n_front, D).
"""
from __future__ import annotations

import functools
from typing import Any

import torch

from repro_torch import autodiff
from repro_torch.configs.base import ArchConfig
from repro_torch.core.aggregation import (aggregate_with_coeffs,
                                          layer_coefficients)
from repro_torch.models import transformer as tr
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

PyTree = Any

__all__ = ["client_batch", "make_train_step", "make_client_grad",
           "make_prefill_step", "make_serve_step"]

_F32 = torch.float32


def client_batch(cfg: ArchConfig, shape, U: int) -> int:
    """Per-client batch b = global_batch / U."""
    assert shape.global_batch % U == 0, (shape.global_batch, U)
    return shape.global_batch // U


def _client_grad(cfg: ArchConfig, params: PyTree, tok: torch.Tensor,
                 lab: torch.Tensor, remat: bool, moe_aux_coef: float = 0.01,
                 frontend=None) -> PyTree:
    """One client's gradient of ``tr.loss_fn`` under autograd, f32,
    congruent with ``params``."""
    leaves = [w.detach().requires_grad_() for w in tree_leaves(params)]
    with torch.enable_grad():
        loss = tr.loss_fn(tree_unflatten(params, leaves), cfg, tok, lab,
                          frontend=frontend, moe_aux_coef=moe_aux_coef,
                          remat=remat)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return tree_unflatten(params, [
        torch.zeros(w.shape, dtype=_F32, device=w.device) if g is None
        else g.to(_F32) for w, g in zip(leaves, grads)])


def _frontend_arg(cfg: ArchConfig, fn):
    """``fn`` (its last argument the frontend) for a config with a
    frontend; else ``fn`` with the frontend fixed to None, so a text-only
    config's signature has no such argument, as the reference's."""
    return fn if cfg.frontend != "none" else functools.partial(
        fn, frontend=None)


def _fold_one(g: PyTree, ids: PyTree, c_row: torch.Tensor) -> PyTree:
    """One client's f32 gradient weighted by its (L,) coefficient row: the
    grouped fold at U = 1."""
    return aggregate_with_coeffs(tree_map(lambda t: t[None], g), ids,
                                 c_row[None])


def _sgd(params: PyTree, agg: PyTree, eta) -> PyTree:
    return tree_map(lambda w, g: (w.to(_F32) - eta * g.to(_F32)).to(w.dtype),
                    params, agg)


def make_train_step(cfg: ArchConfig, *, U: int, mode: str = "temporal",
                    remat: bool = True, moe_aux_coef: float = 0.01):
    """Returns ``train_step(params, tokens, labels, mask, p, eta[,
    frontend])``.

    tokens/labels: (U, b, S) int; mask: (U, L_total) f32 straggler
    contribution mask; p: (L_total,) zero-contributor probabilities; eta:
    the learning rate; frontend: (U, b, n_front, D) for vlm/audio. Returns
    the updated params. A config that routes adds ``moe_aux_coef * aux /
    L`` to each client's loss.
    """
    tr.check_supported(cfg)
    if mode not in ("temporal", "spatial"):
        raise ValueError(f"mode must be 'temporal' or 'spatial', not {mode!r}")

    def client_loss(params, tok, lab, fr):
        return tr.loss_fn(params, cfg, tok, lab, frontend=fr,
                          moe_aux_coef=moe_aux_coef, remat=remat)

    def train_step(params, tokens, labels, mask, p, eta, frontend):
        ids = tr.layer_ids(params, cfg)
        coeffs = layer_coefficients(mask.to(_F32), p.to(_F32))  # (U, L)
        if mode == "spatial":
            grads = torch.func.vmap(
                autodiff.grad(client_loss),
                in_dims=(None, 0, 0, None if frontend is None else 0))(
                    params, tokens, labels, frontend)
            return _sgd(params, aggregate_with_coeffs(grads, ids, coeffs),
                        eta)
        agg = None
        for u in range(U):
            g = _client_grad(cfg, params, tokens[u], labels[u], remat,
                             moe_aux_coef,
                             None if frontend is None else frontend[u])
            part = _fold_one(g, ids, coeffs[u])
            del g
            agg = part if agg is None else tree_map(torch.add, agg, part)
        return _sgd(params, agg, eta)

    return _frontend_arg(cfg, train_step)


def make_client_grad(cfg: ArchConfig, *, remat: bool = True,
                     moe_aux_coef: float = 0.01):
    """The temporal step's per-client body as a function of its own:
    ``client_grad(params, tok (b, S), lab (b, S), c_row (L_total,)[,
    frontend (b, n_front, D)])`` -> the client's f32 gradient weighted by
    its coefficient row (congruent with params), so ``sum_u
    client_grad(..., c[u])`` is the round's fold."""
    tr.check_supported(cfg)

    def client_grad(params, tok, lab, c_row, frontend):
        ids = tr.layer_ids(params, cfg)
        return _fold_one(_client_grad(cfg, params, tok, lab, remat,
                                      moe_aux_coef, frontend),
                         ids, c_row.to(_F32))

    return _frontend_arg(cfg, client_grad)


def _inference(x: torch.Tensor):
    """``torch.inference_mode`` for a step's call, or ``torch.no_grad`` on
    the ``meta`` device (the dry run's): a DTensor cannot be viewed in
    inference mode, and nothing on meta is computed to save."""
    return torch.no_grad() if x.device.type == "meta" else \
        torch.inference_mode()


def make_prefill_step(cfg: ArchConfig):
    """prefill_step(params, tokens[, frontend]) -> last-position logits
    (B, V)."""
    tr.check_supported(cfg)

    def prefill_step(params, tokens, frontend):
        with _inference(tokens):
            return tr.prefill(params, cfg, tokens, frontend=frontend)

    return _frontend_arg(cfg, prefill_step)


def make_serve_step(cfg: ArchConfig):
    """serve_step(params, cache, token, pos) -> (next_token, cache).

    ONE new token against a KV/SSM cache, greedy (argmax), as in the
    reference.
    """
    tr.check_supported(cfg)

    def serve_step(params, cache, token, pos):
        with _inference(token):
            logits, cache = tr.decode_step(params, cfg, cache, token, pos)
            return logits.argmax(-1).to(torch.int32), cache

    return serve_step
