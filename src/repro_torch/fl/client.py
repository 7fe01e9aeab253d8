"""Client-side local training for ADEL-FL and baselines, in PyTorch (port
of ``repro.fl.client``).

A client receives the global model, runs E local SGD iterations on its
minibatch (E=1 is the paper's main setting, Eq. 2) and returns its model
delta ``delta_u = w_t - w_u``. Depth-limited backprop is simulated by
masking deltas per layer at aggregation time, which is identical to
truncating the backward pass.

The per-client deltas of a cohort come from a gradient under
``torch.func.vmap`` over the leading client axis: ``torch.func.grad``'s
values through :func:`repro_torch.autodiff.grad`, which records its
backward only when something can differentiate the delta.
"""
from __future__ import annotations

import functools
from typing import Any, Callable

import torch

from repro_torch import autodiff
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["local_update", "batched_client_deltas", "sample_client_batches"]

PyTree = Any


def local_update(loss_fn: Callable, params: PyTree, x: torch.Tensor,
                 y: torch.Tensor, sample_w: torch.Tensor, eta, *,
                 local_iters: int = 1, l2: float = 0.0) -> PyTree:
    """Run E local SGD iterations; return delta_u = w_t - w_u (pytree).

    loss_fn(params, x, y, sample_w) -> scalar weighted empirical risk.
    """

    def step_loss(p):
        base = loss_fn(p, x, y, sample_w)
        if l2 > 0.0:
            base = base + 0.5 * l2 * sum(
                torch.sum(leaf.to(torch.float32) ** 2)
                for leaf in tree_leaves(p))
        return base

    p = params
    for _ in range(local_iters):
        g = autodiff.grad(step_loss)(p)
        p = tree_map(lambda w, gg: w - eta * gg, p, g)
    return tree_map(lambda w0, w1: w0 - w1, params, p)


def batched_client_deltas(loss_fn: Callable, params: PyTree, xb: torch.Tensor,
                          yb: torch.Tensor, wb: torch.Tensor, eta, *,
                          local_iters: int = 1, l2: float = 0.0) -> PyTree:
    """vmap ``local_update`` over the leading client axis of (xb, yb, wb):
    every leaf of the result carries a leading client axis U."""
    fn = functools.partial(local_update, loss_fn, local_iters=local_iters,
                           l2=l2)
    return torch.func.vmap(fn, in_dims=(None, 0, 0, 0, None))(
        params, xb, yb, wb, eta)


def sample_client_batches(idx: torch.Tensor, data_x: torch.Tensor,
                          data_y: torch.Tensor, n_per_client: torch.Tensor,
                          batch_sizes: torch.Tensor, s_max: int):
    """Uniform with-replacement minibatch per client, padded to s_max.

    ``idx`` (U, s_max) holds raw draws in [0, 2**30) (the run's draw
    source supplies them); as in the reference, client u reads sample
    ``idx % max(n_u, 1)``. data_x: (U, N, ...), data_y: (U, N);
    n_per_client: (U,) valid counts; batch_sizes: (U,) this round's S_t^u.
    Returns (xb, yb, wb) with wb[u, i] = 1/S_u for i < S_u else 0.
    """
    dev = data_x.device
    idx = idx.to(dev) % torch.clamp(n_per_client.to(dev)[:, None], min=1)
    idx = idx.long()
    xb = torch.gather(
        data_x, 1, idx.reshape(idx.shape + (1,) * (data_x.dim() - 2))
        .expand(idx.shape + data_x.shape[2:]))
    yb = torch.gather(data_y, 1, idx)
    S = torch.clamp(batch_sizes.to(dev), 1, s_max).to(torch.float32)
    wb = (torch.arange(s_max, device=dev)[None, :] < S[:, None]) \
        .to(torch.float32) / S[:, None]
    return xb, yb, wb
