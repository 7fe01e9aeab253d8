"""Optimizers and learning-rate schedules for the FL runtime (port of
``repro.optim``).

The paper trains with plain SGD at the clients (Eq. 2) and the server
applies the aggregated update directly (FedAvg is SGD with the aggregated
gradient). ``sgd``/``momentum`` cover the server-side update of the LM
federated step; the schedules are the paper's inverse-decay and constant
profiles. Updates are computed in f32 and cast back to the param's dtype.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map

PyTree = Any

__all__ = ["sgd", "momentum", "inverse_decay", "constant_lr", "Optimizer",
           "clip_by_global_norm"]

_F32 = torch.float32


class Optimizer(NamedTuple):
    init: Callable[[PyTree], PyTree]
    update: Callable[[PyTree, PyTree, PyTree, Any], tuple]
    name: str


def sgd() -> Optimizer:
    """w <- w - eta * g (stateless)."""

    def init(params):
        return ()

    def update(grads, state, params, eta):
        new = tree_map(lambda w, g: (w.to(_F32) - eta * g.to(_F32))
                       .to(w.dtype), params, grads)
        return new, state

    return Optimizer(init, update, "sgd")


def momentum(beta: float = 0.9) -> Optimizer:
    """Polyak momentum: v <- beta v + g; w <- w - eta v."""

    def init(params):
        return tree_map(lambda w: torch.zeros(w.shape, dtype=_F32,
                                              device=w.device), params)

    def update(grads, state, params, eta):
        v = tree_map(lambda s, g: beta * s + g.to(_F32), state, grads)
        new = tree_map(lambda w, vv: (w.to(_F32) - eta * vv).to(w.dtype),
                       params, v)
        return new, v

    return Optimizer(init, update, f"momentum{beta}")


def clip_by_global_norm(grads: PyTree, max_norm: float) -> PyTree:
    """Scale ``grads`` by ``min(1, max_norm / ||grads||)`` (global L2 norm,
    summed in f32)."""
    sq = sum(torch.sum(g.to(_F32) ** 2) for g in tree_leaves(grads))
    scale = torch.clamp(max_norm / torch.clamp(torch.sqrt(sq), min=1e-9),
                        max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads)


def inverse_decay(eta0: float, R: int) -> np.ndarray:
    """eta_t = eta0 / (1 + t), the paper's schedule (satisfies
    eta_t <= 2 eta_{t+1})."""
    t = np.arange(1, R + 1, dtype=np.float32)
    return (eta0 / (1.0 + t)).astype(np.float32)


def constant_lr(eta0: float, R: int) -> np.ndarray:
    return np.full((R,), eta0, np.float32)
