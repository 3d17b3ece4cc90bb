"""Nested-container helpers: the port's stand-in for ``jax.tree``.

Parameters, optimizer and compensation state are nested dicts / lists /
tuples (named tuples included) of tensors. Dict keys flatten in sorted
order, as JAX flattens them, so leaf order and packed layouts match the
reference one to one.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

Tree = Any


def _is_node(x: Any) -> bool:
    return isinstance(x, (dict, list, tuple))


def tree_flatten(tree: Tree) -> Tuple[List[Any], Any]:
    """(leaves, treedef); ``treedef`` rebuilds the containers around leaves."""
    leaves: List[Any] = []

    def walk(node):
        if isinstance(node, dict):
            keys = sorted(node)
            return (dict, tuple(keys), tuple(walk(node[k]) for k in keys))
        if isinstance(node, (list, tuple)):
            return (type(node), None, tuple(walk(c) for c in node))
        leaves.append(node)
        return None

    return leaves, walk(tree)


def tree_unflatten(treedef: Any, leaves: List[Any]) -> Tree:
    it = iter(leaves)

    def build(d):
        if d is None:
            return next(it)
        kind, keys, children = d
        built = [build(c) for c in children]
        if kind is dict:
            return dict(zip(keys, built))
        if kind is list:
            return built
        if hasattr(kind, "_fields"):  # named tuple
            return kind(*built)
        return kind(built)

    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree structure holds")
    return out


def tree_leaves(tree: Tree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` applied leaf-wise over trees of one structure."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r) for r in rest]
    for _, d in others:
        if d != treedef:
            raise ValueError("tree_map over trees of different structure")
    return tree_unflatten(
        treedef, [fn(*xs) for xs in zip(leaves, *(o[0] for o in others))]
    )
