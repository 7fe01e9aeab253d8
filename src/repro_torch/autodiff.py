"""First-order gradients that record their backward only when something
can differentiate the result.

``torch.func.grad`` always runs its backward with ``create_graph=True``,
so autograd records every op of the backward (and keeps its inputs) even
where nothing differentiates the gradient: a client's gradient under the
FL backends' ``vmap``. :func:`grad` takes the same gradient and asks for
the graph only when an outer ``torch.func`` grad transform is active, or
when autograd tracks one of the inputs beneath the transforms' wrappers.
Then a backward that runs with grad mode on always asks for a second
derivative, which is what ``models/transformer.py:_Remat`` reads.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
from torch._C._functorch import (TransformType, get_unwrapped,
                                 is_functorch_wrapped_tensor)
from torch._functorch import eager_transforms as et
from torch._functorch.pyfunctorch import retrieve_all_functorch_interpreters
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.tree import tree_leaves

__all__ = ["grad"]


def _grad_levels() -> int:
    """How many ``torch.func`` grad transforms (``grad``, ``vjp``,
    ``jacrev``) are active around the caller."""
    return sum(i.key() == TransformType.Grad
               for i in retrieve_all_functorch_interpreters())


def _tracked_beneath(tensors) -> bool:
    """Whether autograd itself tracks one of ``tensors`` beneath the
    ``torch.func`` transforms' wrappers."""
    for t in tensors:
        while is_functorch_wrapped_tensor(t):
            t = get_unwrapped(t)
        if t.requires_grad:
            return True
    return False


def _differentiable(args) -> bool:
    """Whether a gradient of ``args`` can itself be differentiated: an
    outer grad transform is active, or autograd tracks one of them."""
    return _grad_levels() > 0 or _tracked_beneath(
        t for t in tree_leaves(args) if isinstance(t, torch.Tensor))


def grad(fn: Callable[..., torch.Tensor]) -> Callable[..., Any]:
    """``torch.func.grad(fn)`` (with respect to the first argument, ``fn``
    returning a scalar), the same transform with one change: its backward
    asks for the graph only when :func:`_differentiable` says the gradient
    can be used, where ``torch.func.grad`` always asks. It is
    ``torch.func.grad``'s own body (``grad_and_value_impl``), since a
    ``torch.func.vjp`` whose backward runs after its level has closed
    fails under ``vmap`` over a block recomputed by ``_Remat``."""

    def wrapper(first, *rest, **kwargs):
        create_graph = _differentiable((first, rest, kwargs))
        with et.grad_increment_nesting() as level:
            with torch.enable_grad():
                first, rest, kwargs = et._wrap_all_tensors(
                    (first, rest, kwargs), level)
                flat, spec = tree_flatten(first)
                for t in flat:
                    et._create_differentiable(t, level)
                out = fn(first, *rest, **kwargs)
                if not (isinstance(out, torch.Tensor) and out.dim() == 0):
                    raise RuntimeError("grad(fn): fn must return a scalar "
                                       "tensor")
                g = et._autograd_grad((out,), flat, create_graph=create_graph)
                return et._undo_create_differentiable(
                    tree_unflatten(g, spec), level)

    return wrapper
