"""Nested containers of tensors: the port's params, grads and optimizer
states are dicts, lists, tuples and NamedTuples of tensors, with ``None``
at a hybrid's attention positions.  ``None`` is an empty subtree, as in
JAX: it has no leaf and maps to ``None``.  Keys are ``"/"``-joined, a
list index its number and a NamedTuple field its name, as the keys JAX's
key paths make (the reference's checkpoint keys)."""
from __future__ import annotations


def _children(tree):
    """(key, child) pairs of a container, or None for a leaf."""
    if isinstance(tree, dict):
        return list(tree.items())
    if hasattr(tree, "_fields"):                # a NamedTuple: by name
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def _rebuild(tree, values):
    if isinstance(tree, dict):
        return dict(zip(tree, values))
    if hasattr(tree, "_fields"):
        return type(tree)(*values)
    return type(tree)(values)


def _child(tree, key):
    return getattr(tree, key) if hasattr(tree, "_fields") else tree[key]


def tree_map(fn, tree, *rest):
    """``tree`` with each leaf ``x`` replaced by ``fn(x, *others)``, the
    others what sits at the same place in ``rest`` (the same structure;
    a dict's entries are found by key)."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn(tree, *rest)
    return _rebuild(tree, [tree_map(fn, v, *(_child(r, k) for r in rest))
                           for k, v in kids])


def map_with_keys(tree, fn, prefix: str = ""):
    """``tree`` with each leaf replaced by ``fn(key, leaf)``."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn(prefix, tree)
    return _rebuild(tree, [
        map_with_keys(v, fn, f"{prefix}/{k}" if prefix else str(k))
        for k, v in kids])


def flatten(tree, prefix: str = "") -> dict:
    """``{"a/0/c": leaf}`` in :func:`tree_map`'s order."""
    out = {}
    map_with_keys(tree, out.__setitem__, prefix)
    return out


def tree_leaves(tree) -> list:
    """The leaves, in :func:`tree_map`'s order."""
    return list(flatten(tree).values())


def tree_unflatten(like, leaves):
    """A tree shaped as ``like`` holding ``leaves`` (in
    :func:`tree_leaves` order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def unzip(like, tree, n: int) -> list:
    """``tree`` holds an n-tuple at each of ``like``'s leaves: the n
    trees shaped as ``like``."""
    return [tree_map(lambda _, t, i=i: t[i], like, tree) for i in range(n)]
