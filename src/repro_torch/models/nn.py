"""Small functional NN building blocks for the paper-scale models, in
PyTorch (port of ``repro.models.nn``).

Tensors keep the reference's layouts at these functions' boundaries: NHWC
activations and HWIO conv weights. ``conv2d`` and ``maxpool2d`` permute to
PyTorch's NCHW/OIHW inside.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["dense_init", "conv_init", "conv2d", "maxpool2d", "group_norm",
           "cross_entropy"]


def _normal(gen: torch.Generator, shape, scale: float, device) -> torch.Tensor:
    """``scale * N(0, 1)`` drawn from ``gen`` (a CPU generator, so a seed
    gives the same params on every device), then moved to ``device``."""
    w = torch.randn(shape, generator=gen, dtype=torch.float32) * scale
    return w.to(device)


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               scale: float | None = None, *, device="cpu") -> dict:
    """He-normal by default; ``scale=0.0`` zero-inits (classifier heads,
    giving exactly log(n_classes) initial CE loss)."""
    scale = scale if scale is not None else float(np.sqrt(2.0 / d_in))
    return {"w": _normal(gen, (d_in, d_out), scale, device),
            "b": torch.zeros((d_out,), dtype=torch.float32, device=device)}


def conv_init(gen: torch.Generator, k: int, c_in: int, c_out: int, *,
              device="cpu") -> dict:
    scale = float(np.sqrt(2.0 / (k * k * c_in)))
    return {"w": _normal(gen, (k, k, c_in, c_out), scale, device),
            "b": torch.zeros((c_out,), dtype=torch.float32, device=device)}


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """NHWC stride-1 SAME conv with HWIO weights."""
    out = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                   padding="same")
    return out.permute(0, 2, 3, 1) + b


def group_norm(x: torch.Tensor, g: torch.Tensor, o: torch.Tensor,
               groups: int = 8, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over NHWC with the population variance (as ``jnp.var``)."""
    N, H, W, C = x.shape
    gs = min(groups, C)
    while C % gs:
        gs -= 1
    xg = x.reshape(N, H, W, gs, C // gs)
    mu = xg.mean(dim=(1, 2, 4), keepdim=True)
    var = xg.var(dim=(1, 2, 4), keepdim=True, correction=0)
    xn = ((xg - mu) * torch.rsqrt(var + eps)).reshape(N, H, W, C)
    return xn * g + o


def maxpool2d(x: torch.Tensor, k: int = 2) -> torch.Tensor:
    """NHWC k x k max pool, stride k, VALID."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), k).permute(0, 2, 3, 1)


def cross_entropy(logits: torch.Tensor, y: torch.Tensor,
                  sample_w: torch.Tensor | None = None) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, y[..., None].long())[..., 0]
    if sample_w is None:
        return nll.mean()
    return (nll * sample_w).sum()
