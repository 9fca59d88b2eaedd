"""Trees of tensors and their gradients, for the training path.

A tree is the port's parameter layout: plain nested dicts, lists and tuples
whose leaves are tensors (or other values, which the maps pass through).
:func:`tree_leaves` lists the leaves in JAX's order (a dict's keys sorted,
a list's items by index), so that a sum over the leaves adds them in the
order the reference adds ``jax.tree.leaves``.  :func:`value_and_grad` is
the counterpart of ``jax.value_and_grad(fn, has_aux=True)``.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator

import torch

__all__ = ["tree_leaves", "tree_map", "tree_unflatten", "value_and_grad"]


def _children(tree) -> list | None:
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(tree)
    return None


def tree_leaves(tree) -> list:
    """The leaves of ``tree``, in JAX's order."""
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for kid in kids for leaf in tree_leaves(kid)]


def tree_unflatten(tree, leaves) -> Any:
    """``tree``'s structure with ``leaves`` (in :func:`tree_leaves` order)."""
    it = iter(leaves)
    out = _rebuild(tree, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def _rebuild(tree, it: Iterator) -> Any:
    if isinstance(tree, dict):
        vals = {k: _rebuild(tree[k], it) for k in sorted(tree)}
        return {k: vals[k] for k in tree}  # the tree's own key order
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return next(it)


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of ``rest``."""
    others = [tree_leaves(t) for t in rest]
    return tree_unflatten(tree, [fn(*xs) for xs in zip(tree_leaves(tree), *others)])


def value_and_grad(fn: Callable) -> Callable:
    """``g(params, *args) -> ((value, aux), grads)`` for ``fn(params, *args)
    -> (scalar value, aux)``: the gradient of the value with respect to
    every floating leaf of ``params`` (zeros where the value does not reach
    it), as a tree of ``params``' structure.

    Each call differentiates fresh ``detach().requires_grad_()`` views of the
    leaves with ``torch.autograd.grad``, and nothing accumulates into a
    shared ``.grad``: threads may call ``g`` on one ``params`` at once.  The
    value and the aux tensors come back detached.
    """

    def g(params, *args, **kwargs):
        leaves = tree_leaves(params)
        live = [p.detach().requires_grad_() if torch.is_tensor(p) and p.is_floating_point()
                else p for p in leaves]
        with torch.enable_grad():
            value, aux = fn(tree_unflatten(params, live), *args, **kwargs)
            wrt = [p for p in live if torch.is_tensor(p) and p.requires_grad]
            grads = iter(torch.autograd.grad(value, wrt, allow_unused=True,
                                             materialize_grads=True))
        out = [next(grads) if torch.is_tensor(p) and p.requires_grad else None for p in live]
        aux = tree_map(lambda a: a.detach() if torch.is_tensor(a) else a, aux)
        return (value.detach(), aux), tree_unflatten(params, out)

    return g
