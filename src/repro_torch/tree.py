"""A small pytree walker over the nested dicts, lists and tuples the port
keeps its parameters and optimizer state in.

It follows ``jax.tree_util``'s conventions, so that names and orders agree
with the reference: dict keys are visited in sorted order, ``None`` is an
empty subtree, anything that is not a dict, list, tuple or ``None`` is a
leaf, and a leaf's path string is ``jax.tree_util.keystr``'s
(``['tables'][0]``: ``[repr(key)]`` per dict level, ``[i]`` per sequence
level). The checkpoint's array names and ``optim.partitioned``'s labels are
these strings.
"""

from __future__ import annotations

from typing import Any, Callable


def _children(node) -> list[tuple[str, Any]] | None:
    """``(path step, child)`` pairs of a node, or None for a leaf."""
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", c) for i, c in enumerate(node)]
    if node is None:
        return []
    return None


# The walkers below are module-level functions that take their accumulator
# as an argument. A recursive closure would form a reference cycle (the
# function and its own cell) that keeps every leaf it saw alive until the
# garbage collector runs: a training step's old tables and gradients, 6.7 GB
# each at dlrm-rm2 width.


def _walk(node, path: str, out: list) -> None:
    kids = _children(node)
    if kids is None:
        out.append((path, node))
        return
    for step, child in kids:
        _walk(child, path + step, out)


def flatten_with_path(tree) -> list[tuple[str, Any]]:
    """``[(keystr path, leaf)]`` in ``jax.tree_util``'s leaf order."""
    out: list[tuple[str, Any]] = []
    _walk(tree, "", out)
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def _walk_up_to(shape, node, out: list) -> None:
    kids = _children(shape)
    if kids is None:
        out.append(node)
        return
    if isinstance(shape, dict):
        if not isinstance(node, dict) or sorted(node) != sorted(shape):
            raise ValueError(f"expected a dict with keys {sorted(shape)}")
        for k in sorted(shape):
            _walk_up_to(shape[k], node[k], out)
    elif shape is not None:
        if not isinstance(node, (list, tuple)) or len(node) != len(shape):
            raise ValueError(f"expected a sequence of {len(shape)}")
        for a, b in zip(shape, node, strict=True):
            _walk_up_to(a, b, out)


def flatten_up_to(like, tree) -> list:
    """The subtrees of ``tree`` at the leaf positions of ``like``
    (``treedef.flatten_up_to``); raises where the structures differ."""
    out: list = []
    _walk_up_to(like, tree, out)
    return out


def _build(node, it):
    if _children(node) is None:
        return next(it)
    if isinstance(node, dict):
        built = {k: _build(node[k], it) for k in sorted(node)}
        return {k: built[k] for k in node}
    if isinstance(node, tuple):
        return tuple([_build(c, it) for c in node])
    if isinstance(node, list):
        return [_build(c, it) for c in node]
    return None


def unflatten(like, values) -> Any:
    """A tree of ``like``'s structure whose leaves are ``values``, taken in
    leaf order (``treedef.unflatten``)."""
    it = iter(values)
    out = _build(like, it)
    if next(it, _END) is not _END:
        raise ValueError("more values than the tree has leaves")
    return out


_END = object()


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``jax.tree.map``: ``fn`` over the leaves of ``tree`` and the matching
    subtrees of ``rest``; the result has ``tree``'s structure."""
    cols = [leaves(tree)] + [flatten_up_to(tree, r) for r in rest]
    return unflatten(tree, [fn(*xs) for xs in zip(*cols, strict=True)])
