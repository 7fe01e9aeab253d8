"""Carry params between the reference's layout (numpy arrays in the JAX
package's pytree) and the port's tensors, leaf for leaf: both packages use
lists of per-layer dicts with HWIO conv weights for the paper models, and
the same nested dict of stacked (L, ...) leaves for the LM, so nothing is
permuted."""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.tree import tree_map

__all__ = ["params_from_jax", "params_to_numpy"]

PyTree = Any


def params_from_jax(np_params: PyTree, device) -> PyTree:
    """The reference's params (numpy arrays or array-likes) as tensors on
    ``device``, same structure, dtypes and values."""
    return tree_map(lambda a: torch.as_tensor(np.array(a), device=device),
                    np_params)


def params_to_numpy(params: PyTree) -> PyTree:
    """The port's params as numpy arrays (same structure)."""
    return tree_map(lambda t: t.detach().cpu().numpy(), params)
