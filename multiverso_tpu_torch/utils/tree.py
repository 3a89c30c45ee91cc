"""Nested containers of tensors or arrays (the torch user's stand-in for
the reference's pytrees): their leaves in a fixed order, and the same
structure rebuilt from new leaves."""

from __future__ import annotations

from typing import Any, Callable, Tuple


def flatten(tree: Any) -> Tuple[list, Callable[[list], Any]]:
    """The leaves of ``tree`` and the function that builds the same
    structure from new leaves (as many, in the same order). A dict's
    leaves come in sorted key order, a list's or tuple's in order, ``None``
    holds none: the order ``jax.tree.flatten`` gives the same containers.
    Anything else is a leaf."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [flatten(tree[k]) for k in keys]
        cls = type(tree)

        def rebuild_dict(leaves):
            out, off = {}, 0
            for k, (sub, build) in zip(keys, parts):
                out[k] = build(leaves[off:off + len(sub)])
                off += len(sub)
            return out if cls is dict else cls(out)
        return [x for sub, _ in parts for x in sub], rebuild_dict
    if isinstance(tree, (list, tuple)):
        parts = [flatten(x) for x in tree]
        cls = type(tree)

        def rebuild_seq(leaves):
            out, off = [], 0
            for sub, build in parts:
                out.append(build(leaves[off:off + len(sub)]))
                off += len(sub)
            # a namedtuple takes its fields as arguments
            return cls(*out) if hasattr(cls, "_fields") else cls(out)
        return [x for sub, _ in parts for x in sub], rebuild_seq
    if tree is None:
        return [], lambda leaves: None
    return [tree], lambda leaves: leaves[0]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of each
    tree in ``rest``, of the same structure), in ``tree``'s structure."""
    leaves, rebuild = flatten(tree)
    others = [flatten(t)[0] for t in rest]
    return rebuild([fn(*xs) for xs in zip(leaves, *others)])
