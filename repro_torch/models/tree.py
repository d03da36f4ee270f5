"""Parameter and cache trees: nested dicts, lists and tuples of tensors.

The reference keeps parameters and caches as JAX pytrees; the port keeps
the same nesting (dict keys, list and tuple positions) so that a tree
carries across leaf for leaf.  :func:`tree_map`, :func:`tree_leaves` and
:func:`tree_unflatten` walk dicts in insertion order; :func:`tree_flatten_sorted` and
:func:`tree_unflatten_sorted` walk them in sorted-key order, which is
``jax.tree_util.tree_flatten``'s, so a checkpoint numbers its leaves as
the reference's does.
"""

from __future__ import annotations

from typing import Callable, List

__all__ = ["tree_map", "tree_leaves", "tree_unflatten", "tree_flatten_sorted",
           "tree_unflatten_sorted"]


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


def tree_unflatten(like, leaves):
    """A tree of ``like``'s structure holding ``leaves`` in the order
    :func:`tree_leaves` gives ``like``'s."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def tree_flatten_sorted(tree) -> List:
    """The leaves of ``tree`` in ``jax.tree_util.tree_flatten``'s order:
    dict keys sorted, lists and tuples in order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_flatten_sorted(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_flatten_sorted(t)]
    return [tree]


def tree_unflatten_sorted(like, leaves):
    """A tree of ``like``'s structure whose leaves are ``leaves``, taken in
    :func:`tree_flatten_sorted`'s order."""
    leaves = list(leaves)
    if len(leaves) != len(tree_flatten_sorted(like)):
        raise ValueError(f"{len(leaves)} leaves for a tree of "
                         f"{len(tree_flatten_sorted(like))}")
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(t) for t in node)
        return next(it)

    return build(like)
