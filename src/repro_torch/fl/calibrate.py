"""Pilot-round estimation of the Theorem-1 analysis constants (port of
``repro.fl.calibrate``).

The paper (A2/A3) assumes the per-user gradient-variance bounds sigma_u^2
and the gradient-norm bound G^2 are known to the server when it solves
Problem 2. On a real system they are not: this module estimates them from
a handful of per-sample gradients at the initial model, the pilot phase of
Algorithm 1 (server-side, before round 1):

  sigma_u^2 ~= E_i ||grad F_u(w_1; i) - grad F_u(w_1)||^2      (A2 at S=1)
  G^2       ~= max_u E_i ||grad F_u(w_1; i_ref)||^2            (A3)

where i_ref is a reference batch of size ``g_ref_batch``. The per-sample
gradients are one ``torch.func.vmap`` of a gradient
(:func:`repro_torch.autodiff.grad`) a client.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch import autodiff
from repro_torch.core.types import AnalysisConfig
from repro_torch.tree import tree_leaves

__all__ = ["calibrate_constants"]

PyTree = Any


def _flat_grad(loss_fn, params: PyTree, x: torch.Tensor,
               y: torch.Tensor) -> torch.Tensor:
    """The gradient of the 1/n-weighted loss over (x, y), flattened in leaf
    order."""
    n = y.shape[0]
    w = torch.full((n,), 1.0 / n, dtype=torch.float32, device=y.device)
    g = autodiff.grad(loss_fn)(params, x, y, w)
    return torch.cat([t.reshape(-1) for t in tree_leaves(g)])


def calibrate_constants(cfg: AnalysisConfig, model, params: PyTree, client_x,
                        client_y, n_per_client, *, n_probe: int = 32,
                        g_ref_batch: int = 8) -> AnalysisConfig:
    """Return ``cfg`` with ``sigma2`` ((U,) float32) and ``G2`` replaced by
    pilot estimates from at most ``n_probe`` (at least 2) samples of each
    client. Runs on the params' device."""
    dev = tree_leaves(params)[0].device
    sig2 = np.zeros(cfg.U, np.float32)
    g2 = np.zeros(cfg.U, np.float32)

    def one(x1, y1):
        return _flat_grad(model.loss, params, x1[None], y1[None])

    for u in range(cfg.U):
        n = max(min(int(n_per_client[u]), n_probe), 2)
        xs = torch.as_tensor(np.asarray(client_x[u][:n]), device=dev)
        ys = torch.as_tensor(np.asarray(client_y[u][:n]), device=dev)
        full = _flat_grad(model.loss, params, xs, ys)
        per = torch.func.vmap(one)(xs, ys)
        var1 = ((per - full[None]) ** 2).sum(-1).mean()
        # E||batch grad||^2 at the reference batch size: full^2 + var1/S_ref
        gref = (full ** 2).sum() + var1 / g_ref_batch
        sig2[u] = float(var1)
        g2[u] = float(gref)
    return dataclasses.replace(cfg, sigma2=sig2, G2=float(g2.max()))
