"""Parameter trees: the few ``jax.tree_util`` operations the optimizers,
the train loop and the training checkpoints need, over the port's trees.

A tree is a tensor (a leaf), ``None`` (no leaves), a dict, a list or
tuple, or a :class:`~repro_torch.models.layers.ParamTree` (read as the
dict of its parameters and children; an ``nn.ParameterList`` or
``nn.ModuleList`` inside it as a list).  Leaves come in
``jax.tree_util``'s order: dict keys sorted, list items by position,
so a leaf's path name (``"opt/mu/convs/0/w"``) and its place are the
reference's for the same nested structure.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

import torch
from torch import nn

SEP = "/"


def _items(node) -> List[Tuple[Any, Any]]:
    """``(key, child)`` pairs of a container, in the reference's order;
    an empty list for ``None``.  Raises ``TypeError`` on a leaf."""
    if node is None:
        return []
    if isinstance(node, (nn.ParameterList, nn.ModuleList)):
        return list(enumerate(node))
    if isinstance(node, nn.Module):
        named = dict(node.named_parameters(recurse=False))
        named.update(node.named_children())
        return sorted(named.items())
    if isinstance(node, dict):
        return sorted(node.items())
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    raise TypeError(f"{type(node).__name__} is a leaf")


def is_leaf(node) -> bool:
    return node is not None and not isinstance(
        node, (nn.Module, dict, list, tuple))


def _walk(node, path: Tuple[str, ...]) -> Iterator[Tuple[Tuple[str, ...],
                                                         Any]]:
    if is_leaf(node):
        yield path, node
        return
    for key, child in _items(node):
        yield from _walk(child, path + (str(key),))


def flatten_with_paths(tree) -> List[Tuple[str, Any]]:
    """``[(name, leaf)]`` with names joined by ``/`` (the reference's
    checkpoint leaf names)."""
    return [(SEP.join(p), leaf) for p, leaf in _walk(tree, ())]


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in _walk(tree, ())]


def unflatten(like, values) -> Any:
    """A tree of ``like``'s structure (a ParamTree read as a dict) whose
    leaves are ``values`` in order."""
    it = iter(values)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more values than leaves")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure).  Returns plain containers: a ParamTree
    becomes a dict, a parameter or module list a list; ``None`` stays."""
    if is_leaf(tree):
        return fn(tree, *rest)
    if tree is None:
        return None
    items = _items(tree)
    mapped = {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in items}
    if not isinstance(tree, (list, tuple, nn.ParameterList, nn.ModuleList)):
        return mapped
    out = [mapped[i] for i in range(len(items))]
    return tuple(out) if isinstance(tree, tuple) else out


def assign(params, values):
    """``values`` as the new parameters: copied in place into a
    ``nn.Module`` (so every engine built on it scores with them), else
    returned as they are."""
    if not isinstance(params, nn.Module):
        return values
    with torch.no_grad():
        for p, v in zip(leaves(params), leaves(values), strict=True):
            p.copy_(v)
    return params
