"""Parameter and cache trees: nested dicts, lists and tuples of tensors.

The reference keeps parameters and caches as JAX pytrees; the port keeps
the same nesting (dict keys, list and tuple positions) so that a tree
carries across leaf for leaf.  These two helpers are all the tree
handling the port needs.
"""

from __future__ import annotations

from typing import Callable, List

__all__ = ["tree_map", "tree_leaves"]


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` to the leaves of ``tree`` (and the matching leaves of
    each tree in ``rest``), keeping the nesting and container types."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree)]
        return type(tree)(out)
    return fn(tree, *rest)


def tree_leaves(tree) -> List:
    """The leaves of ``tree`` in the order :func:`tree_map` visits them."""
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]
