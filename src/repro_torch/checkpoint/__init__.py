"""Pytree checkpointing (port of ``repro.checkpoint``): a flat ``.npz`` of
leaves plus a JSON manifest (the tree's structure, round index, metadata),
in the reference's file layout, so each package reads the other's
checkpoints. Leaves are stored in ``jax.tree`` order (dict keys sorted) as
``leaf_<i>``; bf16 leaves, which numpy cannot hold, are stored as their f32
values and cast back on load."""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_unflatten

PyTree = Any

__all__ = ["save_checkpoint", "load_checkpoint", "latest_checkpoint"]


def _treedef(tree: PyTree) -> str:
    """The structure as ``jax.tree.structure`` prints it: dicts (keys
    sorted), lists and tuples, ``*`` for a leaf."""
    def walk(t) -> str:
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {walk(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, list):
            return "[" + ", ".join(walk(x) for x in t) + "]"
        if isinstance(t, tuple):
            return "(" + ", ".join(walk(x) for x in t) + \
                ("," if len(t) == 1 else "") + ")"
        return "*"
    return f"PyTreeDef({walk(tree)})"


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        return (t.to(torch.float32) if t.dtype == torch.bfloat16
                else t).numpy()
    return np.asarray(leaf)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace("torch.", "")
    return str(np.asarray(leaf).dtype)


def save_checkpoint(path: str, params: PyTree, *, step: int = 0,
                    meta: dict | None = None) -> None:
    """Write ``path + ".npz"`` (the leaves) and ``path + ".json"``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    leaves = tree_leaves(params)
    arrays = {f"leaf_{i}": _numpy(leaf) for i, leaf in enumerate(leaves)}
    np.savez(path + ".npz", **arrays)
    manifest = {"treedef": _treedef(params), "n_leaves": len(leaves),
                "step": step, "meta": meta or {},
                "dtypes": [_dtype_name(leaf) for leaf in leaves],
                "shapes": [list(leaf.shape) for leaf in leaves]}
    with open(path + ".json", "w") as f:
        json.dump(manifest, f, indent=1)


def load_checkpoint(path: str, like: PyTree) -> tuple[PyTree, dict]:
    """Restore into the structure of ``like`` (leaf count and shapes
    validated): each leaf takes ``like``'s leaf's dtype and device. Returns
    ``(params, manifest)``."""
    with open(path + ".json") as f:
        manifest = json.load(f)
    data = np.load(path + ".npz")
    leaves = tree_leaves(like)
    if len(leaves) != manifest["n_leaves"]:
        raise ValueError(f"structure mismatch: {len(leaves)} leaves, the "
                         f"checkpoint has {manifest['n_leaves']}")
    out = []
    for i, ref in enumerate(leaves):
        arr = data[f"leaf_{i}"]
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"leaf {i}: {arr.shape} != {tuple(ref.shape)}")
        out.append(torch.as_tensor(arr).to(device=ref.device,
                                           dtype=ref.dtype))
    return tree_unflatten(like, out), manifest


def latest_checkpoint(directory: str, prefix: str = "ckpt") -> str | None:
    """The path (without suffix) of the checkpoint in ``directory`` whose
    manifest has the highest step, or None."""
    if not os.path.isdir(directory):
        return None
    best, best_step = None, -1
    for fn in os.listdir(directory):
        if fn.startswith(prefix) and fn.endswith(".json"):
            try:
                with open(os.path.join(directory, fn)) as f:
                    step = json.load(f).get("step", 0)
            except (OSError, ValueError):
                continue
            if step > best_step:
                best, best_step = os.path.join(directory, fn[:-5]), step
    return best
