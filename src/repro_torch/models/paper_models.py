"""The paper's own experimental models (Section IV), as ModelAPIs, in
PyTorch (port of ``repro.models.paper_models``).

* MLP  — two hidden layers (32, 16) + softmax output; L = 3      (MNIST)
* CNN  — two 5x5 convs (pool+ReLU) + two dense layers; L = 4     (MNIST)
* VGG11 / VGG13 — 8/10 convs with GroupNorm + 3 dense; L = 11/13 (CIFAR-10)

Params are the reference's pytree: a list of per-layer dicts of float32
tensors, HWIO conv weights, NHWC activations — so params and ``layer_ids``
cross between the two packages unchanged (:mod:`repro_torch.convert`).
``init(gen, device)`` draws from a ``torch.Generator``. HeteroFL width
masks (``ModelAPI.width_masks``) are provided for all models.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from repro_torch.fl.runtime import ModelAPI
from .nn import (conv2d, conv_init, cross_entropy, dense_init, group_norm,
                 maxpool2d)

__all__ = ["make_mlp", "make_cnn", "make_vgg"]


def _layer_ids(params):
    """Whole-tensor layer ids: every leaf of layer i maps to ``i``."""
    return [{k: i for k in layer} for i, layer in enumerate(params)]


def _hidden_width_masks(params, ratios: np.ndarray):
    """HeteroFL: client u updates the first ceil(r_u * width) output units
    of every hidden layer (and the matching input slices of the next
    layer), as the reference slices them: dense weights ``(d_in, d_out)``,
    conv weights HWIO ``(k, k, c_in, c_out)``, 1-D per-output-unit leaves
    (bias, norm scale/offset) on their only axis. The output layer's units
    are never width-masked; its input dim follows the previous layer's
    kept units. Returns float32 masks with a leading client axis, built on
    the params' device."""
    L = len(params)
    r = [float(v) for v in np.asarray(ratios, np.float32)]
    U = len(r)
    dev = params[0]["w"].device

    def keep(fracs, dim):
        k = ([dim] * U if fracs is None else
             [max(1, int(math.ceil(f * dim))) for f in fracs])
        return torch.tensor(k, device=dev)

    def first(n, k):
        """(U, n): entry j of row u is kept iff j < k[u]."""
        return torch.arange(n, device=dev)[None, :] < k[:, None]

    masks = []
    prev = None               # fraction kept of the previous layer's outputs
    for i, layer in enumerate(params):
        w = layer["w"]
        out_dim = w.shape[-1]
        in_dim = w.shape[0] if w.dim() == 2 else w.shape[2]
        k_out = keep(None if i == L - 1 else r, out_dim)
        m = (first(in_dim, keep(prev, in_dim))[:, :, None]
             & first(out_dim, k_out)[:, None, :])          # (U, in, out)
        if w.dim() != 2:                                    # HWIO conv
            m = m[:, None, None].expand((U,) + tuple(w.shape))
        layer_mask = {"w": m.to(torch.float32).contiguous()}
        for key, leaf in layer.items():
            if key != "w":
                layer_mask[key] = first(leaf.shape[0], k_out).to(torch.float32)
        masks.append(layer_mask)
        prev = None if i == L - 1 else r
    return masks


def _dense(h: torch.Tensor, layer: dict) -> torch.Tensor:
    return h @ layer["w"] + layer["b"]


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def make_mlp(input_dim: int = 784, hidden: Sequence[int] = (32, 16),
             n_classes: int = 10) -> ModelAPI:
    dims = [input_dim, *hidden, n_classes]
    L = len(dims) - 1

    def init(gen, device):
        return [dense_init(gen, dims[i], dims[i + 1],
                           scale=0.0 if i == L - 1 else None, device=device)
                for i in range(L)]

    def forward(params, x):
        h = x.reshape(x.shape[0], -1)
        for i, layer in enumerate(params):
            h = _dense(h, layer)
            if i < L - 1:
                h = torch.relu(h)
        return h

    def loss(params, x, y, w):
        return cross_entropy(forward(params, x), y, w)

    return ModelAPI(init=init, loss=loss, predict=forward,
                    layer_ids=_layer_ids, L=L, name="mlp",
                    width_masks=_hidden_width_masks)


# ---------------------------------------------------------------------------
# CNN (two 5x5 convs + two dense)
# ---------------------------------------------------------------------------

def make_cnn(in_hw: int = 28, in_c: int = 1, n_classes: int = 10,
             c1: int = 8, c2: int = 16, fc: int = 64) -> ModelAPI:
    L = 4
    flat_hw = in_hw // 4

    def init(gen, device):
        return [conv_init(gen, 5, in_c, c1, device=device),
                conv_init(gen, 5, c1, c2, device=device),
                dense_init(gen, flat_hw * flat_hw * c2, fc, device=device),
                dense_init(gen, fc, n_classes, scale=0.0, device=device)]

    def forward(params, x):
        h = torch.relu(maxpool2d(conv2d(x, params[0]["w"], params[0]["b"])))
        h = torch.relu(maxpool2d(conv2d(h, params[1]["w"], params[1]["b"])))
        h = h.reshape(h.shape[0], -1)
        h = torch.relu(_dense(h, params[2]))
        return _dense(h, params[3])

    def loss(params, x, y, w):
        return cross_entropy(forward(params, x), y, w)

    return ModelAPI(init=init, loss=loss, predict=forward,
                    layer_ids=_layer_ids, L=L, name="cnn",
                    width_masks=_hidden_width_masks)


# ---------------------------------------------------------------------------
# VGG-11 / VGG-13 (Simonyan & Zisserman), width-scalable
# ---------------------------------------------------------------------------

_VGG_PLANS = {
    11: [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    13: [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
}


def make_vgg(depth: int = 11, in_hw: int = 32, in_c: int = 3,
             n_classes: int = 10, width_scale: float = 1.0,
             fc_dim: int = 512) -> ModelAPI:
    plan = _VGG_PLANS[depth]
    convs = [(max(4, int(c * width_scale)) if c != "M" else "M") for c in plan]
    n_conv = sum(1 for c in convs if c != "M")
    fc_dim = max(8, int(fc_dim * width_scale))
    L = n_conv + 3
    n_pool = sum(1 for c in convs if c == "M")
    final_hw = in_hw // (2 ** n_pool)
    last_c = [c for c in convs if c != "M"][-1]
    flat = final_hw * final_hw * last_c

    def init(gen, device):
        params = []
        c_prev = in_c
        for c in convs:
            if c == "M":
                continue
            layer = conv_init(gen, 3, c_prev, c, device=device)
            # GroupNorm affine params in the same per-layer dict, so ADEL's
            # layer masks cover them
            layer["g"] = torch.ones((c,), dtype=torch.float32, device=device)
            layer["o"] = torch.zeros((c,), dtype=torch.float32, device=device)
            params.append(layer)
            c_prev = c
        params.append(dense_init(gen, flat, fc_dim, device=device))
        params.append(dense_init(gen, fc_dim, fc_dim, device=device))
        params.append(dense_init(gen, fc_dim, n_classes, scale=0.0,
                                 device=device))
        return params

    def forward(params, x):
        h = x
        pi = 0
        for c in convs:
            if c == "M":
                h = maxpool2d(h)
            else:
                p = params[pi]
                h = conv2d(h, p["w"], p["b"])
                h = torch.relu(group_norm(h, p["g"], p["o"]))
                pi += 1
        h = h.reshape(h.shape[0], -1)
        h = torch.relu(_dense(h, params[pi])); pi += 1
        h = torch.relu(_dense(h, params[pi])); pi += 1
        return _dense(h, params[pi])

    def loss(params, x, y, w):
        return cross_entropy(forward(params, x), y, w)

    return ModelAPI(init=init, loss=loss, predict=forward,
                    layer_ids=_layer_ids, L=L, name=f"vgg{depth}",
                    width_masks=_hidden_width_masks)
