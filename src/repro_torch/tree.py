"""Minimal pytree helpers over the nested dicts/lists that hold params and
caches (the port's stand-in for `jax.tree.map` / `jax.tree.leaves`).

`tree_leaves` walks dicts in insertion order; `tree_flatten` /
`tree_unflatten` walk them in jax's order (keys sorted, lists in order,
a dataclass's fields in declaration order), which the checkpoint format
and the optimizer's global norm follow."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional


def tree_map(fn: Callable, tree: Any, *rest: Any,
             is_leaf: Optional[Callable[[Any], bool]] = None) -> Any:
    """Apply `fn` leafwise over trees of identical structure.  Dicts and
    lists/tuples are containers; None stays None; anything else is a leaf,
    and so is any node for which `is_leaf` holds (a spec tree's tuples)."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest),
                            is_leaf=is_leaf) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest),
                                   is_leaf=is_leaf)
                          for i, t in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree: Any,
                is_leaf: Optional[Callable[[Any], bool]] = None) -> List[Any]:
    if is_leaf is not None and is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in tree for x in tree_leaves(tree[k], is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t, is_leaf)]
    if tree is None:
        return []
    return [tree]


def tree_flatten(tree: Any) -> List[Any]:
    """The leaves in `jax.tree_util.tree_flatten`'s order: dict keys
    sorted, lists/tuples in order, a dataclass's fields (e.g. AdamWState's
    step, mu, nu) in declaration order; None holds no leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_flatten(t)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [x for f in dataclasses.fields(tree)
                for x in tree_flatten(getattr(tree, f.name))]
    if tree is None:
        return []
    return [tree]


def tree_unflatten(like: Any, leaves: List[Any]) -> Any:
    """A tree of `like`'s structure (dict insertion order kept) holding
    `leaves`, given in `tree_flatten`'s order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(t) for t in node)
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            return dataclasses.replace(node, **{
                f.name: build(getattr(node, f.name))
                for f in dataclasses.fields(node)})
        if node is None:
            return None
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
