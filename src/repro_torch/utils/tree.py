"""Param trees: nested dicts and lists of tensors, laid out like the
reference's pytrees.  Dict keys flatten in sorted order, as JAX
flattens them, so leaf i of the port is leaf i of the reference."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

Path = Tuple[Any, ...]


def _children(tree) -> List[Tuple[Any, Any]]:
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return []


def _is_node(tree) -> bool:
    return isinstance(tree, (dict, list, tuple))


def flatten_with_path(tree, prefix: Path = ()) -> List[Tuple[Path, Any]]:
    """[(path, leaf)] in the reference's leaf order."""
    if not _is_node(tree):
        return [(prefix, tree)]
    out = []
    for k, child in _children(tree):
        out += flatten_with_path(child, prefix + (k,))
    return out


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in flatten_with_path(tree)]


def flatten_up_to(structure, tree) -> List[Any]:
    """The subtrees of ``tree`` at the leaf positions of ``structure``."""
    if not _is_node(structure):
        return [tree]
    out = []
    for k, child in _children(structure):
        out += flatten_up_to(child, tree[k])
    return out


def unflatten(structure, flat: List[Any]):
    """A tree shaped like ``structure`` with ``flat`` at its leaves."""
    it = iter(flat)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return [build(c) for c in node]
        return next(it)

    return build(structure)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` on the leaves of ``tree`` and the matching leaves of
    ``rest``, which share its structure."""
    flat = [flatten_up_to(tree, r) for r in rest]
    return unflatten(tree, [fn(leaf, *others) for leaf, *others
                            in zip(leaves(tree), *flat)])


def to_device(tree, device):
    """A tree of tensors, NamedTuples included, moved to ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    if isinstance(tree, tuple):
        return type(tree)(*(to_device(v, device) for v in tree))
    return tree.to(device)
