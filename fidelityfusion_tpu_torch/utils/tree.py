"""Nested dict / list / tuple parameter trees of tensors."""

from __future__ import annotations


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leafwise over trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves in `tree_map` order."""
    out = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(tree, leaves) -> object:
    """A tree shaped like ``tree`` holding ``leaves`` in `tree_leaves` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)
