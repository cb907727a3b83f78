"""Parameter-tree walks in ``repro``'s leaf order.

``repro`` flattens its trees with ``jax.tree_util``: dict keys in sorted
order, lists and tuples in order, ``None`` an empty subtree, NamedTuples
(a train state, an optimizer state) their fields in declaration order,
and every other object (arrays, Python ints and bools, containers) one
leaf.  The checkpoint store numbers its leaves in that order and the
fault campaign keys each leaf's generator by the leaf's path string
(``jax.tree_util.keystr``: ``"['blocks'][0]['c1']['conv']['w']"``, a
NamedTuple field as ``".params"``), so the port walks its trees the same
way to read and write the same artifacts and flip the same bits.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import torch

__all__ = ["flatten", "leaves_with_path", "unflatten", "map_with_path",
           "tree_map", "keystr", "describe", "GetAttrKey", "is_float"]

Path = Tuple[Any, ...]
IsLeaf = Optional[Callable[[Any], bool]]


class GetAttrKey(str):
    """The key of a NamedTuple field in a path (``jax.tree_util``'s
    ``GetAttrKey``): the field's name, written ``.name`` by
    :func:`keystr`."""


def is_float(x: Any) -> bool:
    """A floating-point tensor leaf: what the optimizers update, the
    gradient wire compresses and autograd differentiates."""
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def _is_namedtuple(node: Any) -> bool:
    return isinstance(node, tuple) and hasattr(type(node), "_fields")


def _rebuild(node: Any, children) -> Any:
    """A list, tuple or NamedTuple like ``node`` holding ``children``."""
    if _is_namedtuple(node):
        return type(node)(*children)
    return type(node)(children)


def _items(node: Any):
    """(key, child) pairs of an inner node in flatten order, or None for
    a leaf.  ``None`` is an inner node with no children."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(GetAttrKey(f), getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    if node is None:
        return []
    return None


def _walk(node: Any, path: Path, is_leaf: IsLeaf, out: List):
    kids = None if is_leaf is not None and is_leaf(node) else _items(node)
    if kids is None:
        out.append((path, node))
        return
    for k, v in kids:
        _walk(v, path + (k,), is_leaf, out)


def flatten(tree: Any, is_leaf: IsLeaf = None) -> Tuple[List[Any], Any]:
    """``(leaves, treedef)``; ``treedef`` is the tree itself, the template
    :func:`unflatten` fills."""
    return ([leaf for _, leaf in leaves_with_path(tree, is_leaf)],
            (tree, is_leaf))


def leaves_with_path(tree: Any, is_leaf: IsLeaf = None
                     ) -> List[Tuple[Path, Any]]:
    """``(path, leaf)`` pairs in flatten order
    (``jax.tree_util.tree_flatten_with_path``)."""
    out: List = []
    _walk(tree, (), is_leaf, out)
    return out


def unflatten(treedef: Any, leaves: List[Any]) -> Any:
    """The tree of ``treedef`` with its leaves replaced, in flatten order,
    by ``leaves``; dicts keep the template's key order."""
    template, is_leaf = treedef
    it = iter(leaves)

    def build(node):
        if is_leaf is not None and is_leaf(node):
            return next(it)
        if isinstance(node, dict):
            vals = {k: build(node[k]) for k in sorted(node)}
            return {k: vals[k] for k in node}
        if isinstance(node, (list, tuple)):
            return _rebuild(node, [build(v) for v in node])
        if node is None:
            return None
        return next(it)

    out = build(template)
    if next(it, it) is not it:
        raise ValueError("more leaves than the tree has")
    return out


def map_with_path(fn: Callable[[Path, Any], Any], tree: Any,
                  is_leaf: IsLeaf = None, path: Path = ()) -> Any:
    """Rebuild ``tree`` with ``fn(path, leaf)`` at every leaf; ``path``
    holds the raw keys (dict keys, sequence indices)."""
    if is_leaf is not None and is_leaf(tree):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, is_leaf, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return _rebuild(tree, [map_with_path(fn, v, is_leaf, path + (k,))
                               for k, v in _items(tree)])
    if tree is None:
        return None
    return fn(path, tree)


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and, leaf for leaf, of each tree
    in ``rest`` (the same structure): ``jax.tree_util.tree_map``."""
    leaves, treedef = flatten(tree)
    others = [flatten(t)[0] for t in rest]
    if any(len(o) != len(leaves) for o in others):
        raise ValueError(f"tree_map: trees of {len(leaves)} and "
                         f"{[len(o) for o in others]} leaves")
    return unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])


def keystr(path: Path) -> str:
    """``jax.tree_util.keystr`` of a dict / sequence / NamedTuple key
    path."""
    return "".join(f".{k}" if isinstance(k, GetAttrKey)
                   else f"[{k}]" if isinstance(k, int)
                   and not isinstance(k, bool) else f"[{k!r}]"
                   for k in path)


def describe(tree: Any, is_leaf: IsLeaf = None) -> str:
    """The tree's structure with ``*`` for each leaf, in flatten order
    (``{'b': *, 'w': *}``) — the checkpoint manifest's ``treedef``."""
    if is_leaf is not None and is_leaf(tree):
        return "*"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {describe(tree[k], is_leaf)}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(describe(v, is_leaf) for v in tree) + "]"
    if _is_namedtuple(tree):
        return type(tree).__name__ + "(" + ", ".join(
            f"{f}={describe(getattr(tree, f), is_leaf)}"
            for f in tree._fields) + ")"
    if isinstance(tree, tuple):
        inner = ", ".join(describe(v, is_leaf) for v in tree)
        return "(" + inner + ("," if len(tree) == 1 else "") + ")"
    if tree is None:
        return "None"
    return "*"
