"""Nested-dict trees of tensors: the port's stand-in for `jax.tree`.

Leaves are visited in sorted-key order, as `jax.tree.flatten` visits a
dict, so sums over leaves run in the JAX package's order and checkpoint leaf
keys (`"params/layers/wq"`) match its `tree_flatten_with_path` names.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List


def tree_map(fn: Callable, tree, *rest):
    """`fn` over the leaves of `tree` and the same-shaped `rest` trees."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree) -> List[Any]:
    """Leaves in sorted-key order; a list (the hybrid family's per-layer
    cache) in its own order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    return [tree]


def tree_paths(tree, prefix: str = "") -> Dict[str, Any]:
    """{"a/b/c": leaf} in sorted-key order; list items are keyed by their
    index ("layers/0/h")."""
    if isinstance(tree, (dict, list)):
        keys = sorted(tree) if isinstance(tree, dict) else range(len(tree))
        out: Dict[str, Any] = {}
        for k in keys:
            out.update(tree_paths(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def tree_from_paths(values: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of `tree_paths`: nested dicts from "a/b/c" keys."""
    out: Dict[str, Any] = {}
    for key, leaf in values.items():
        *parents, last = key.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return out
