"""Pytrees of tensors in the JAX package's flatten order.

The port's optimizer state and checkpoints are nested containers of tensors.
Their leaves are flattened in the order ``jax.tree_util.tree_flatten`` gives
the same containers, because a checkpoint's leaf files are numbered in that
order and either package must restore the other's:

* a mapping's values by sorted key;
* a list's or a plain tuple's items in order;
* a ``NamedTuple``'s fields in field order;
* ``None`` holds no leaf;
* anything else is one leaf.

``treedef_token`` spells the structure as ``str(PyTreeDef)`` does, for the
``treedef`` field of a checkpoint's ``tree.json`` (written, never read).
"""
from __future__ import annotations

from typing import Any, Callable, List, Mapping

Tree = Any


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def leaves(tree: Tree) -> List[Any]:
    """The leaves of ``tree``, in JAX's flatten order."""
    out: List[Any] = []
    _collect(tree, out)
    return out


def _collect(node, out: List[Any]) -> None:
    if node is None:
        return
    if isinstance(node, Mapping):
        for k in sorted(node):
            _collect(node[k], out)
    elif isinstance(node, (list, tuple)):
        for x in node:
            _collect(x, out)
    else:
        out.append(node)


def unflatten(tree: Tree, new_leaves: List[Any]) -> Tree:
    """A tree of ``tree``'s structure holding ``new_leaves`` in flatten
    order; ``ValueError`` where their count is not the structure's."""
    it = iter(new_leaves)
    want = len(leaves(tree))
    if len(new_leaves) != want:
        raise ValueError(f"{len(new_leaves)} leaves for a tree of {want}")
    return _rebuild(tree, it)


def _rebuild(node, it):
    if node is None:
        return None
    if isinstance(node, Mapping):
        built = {k: _rebuild(node[k], it) for k in sorted(node)}
        return {k: built[k] for k in node}          # the caller's key order
    if _is_namedtuple(node):
        return type(node)(*(_rebuild(x, it) for x in node))
    if isinstance(node, (list, tuple)):
        return type(node)(_rebuild(x, it) for x in node)
    return next(it)


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` applied leaf by leaf over ``tree`` and trees of its
    structure."""
    flat = [leaves(t) for t in (tree, *rest)]
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)])


def treedef_token(node: Tree) -> str:
    """The structure as ``str(jax.tree_util.tree_structure(...))`` spells
    it, e.g. ``PyTreeDef({'a': [*, *], 'b': None})``."""
    return f"PyTreeDef({_spell(node)})"


def _spell(node) -> str:
    if node is None:
        return "None"
    if isinstance(node, Mapping):
        return "{" + ", ".join(f"{k!r}: {_spell(node[k])}"
                               for k in sorted(node)) + "}"
    if _is_namedtuple(node):
        return (f"CustomNode(namedtuple[{type(node).__name__}], ["
                + ", ".join(_spell(x) for x in node) + "])")
    if isinstance(node, list):
        return "[" + ", ".join(_spell(x) for x in node) + "]"
    if isinstance(node, tuple):
        inner = ", ".join(_spell(x) for x in node)
        return f"({inner},)" if len(node) == 1 else f"({inner})"
    return "*"


# the keys under which the port's parameter trees hold lists of layers that
# the reference stacks into banks: ``blocks``, ``tail``, a local_global
# group's ``local``, and ``groups`` (a list of local_global groups, or a
# hybrid model's list of lists of layers).  An MoE model's ``lead`` blocks
# are a plain list in the reference too, so they are not stacked.  A
# serving cache's layers (``KVCache``, ``Mamba1State``: NamedTuples) stack
# under the same keys into the reference's cache banks.
BANKS = ("blocks", "groups", "local", "tail")


def _is_bank(key, node) -> bool:
    return (key in BANKS and isinstance(node, list) and bool(node)
            and all(isinstance(x, (Mapping, list)) or _is_namedtuple(x)
                    for x in node))


def _stack_bank(rows: list, stack: Callable[[List[Any]], Any]) -> Tree:
    """One bank of ``rows`` (layers, or lists of layers for a further
    axis), each row's own banks stacked first."""
    rows = [_stack_bank(r, stack) if isinstance(r, list)
            else stack_layers(r, stack) for r in rows]
    return tree_map(lambda *xs: stack(list(xs)), *rows)


def stack_layers(tree: Tree, stack: Callable[[List[Any]], Any]) -> Tree:
    """``tree`` with every list of layers under a ``BANKS`` key turned into
    one mapping of leaves stacked on a new axis 0 by ``stack`` (the JAX
    package's layer banks); a list of lists of layers stacks on two axes,
    (groups, layers), and a bank inside each layer (a group's ``local``)
    on an axis after the outer one."""
    if isinstance(tree, Mapping):
        return {k: _stack_bank(v, stack) if _is_bank(k, v)
                else stack_layers(v, stack) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(stack_layers(x, stack) for x in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(stack_layers(x, stack) for x in tree)
    return tree


def _unstack_bank(rows: list, stacked: Tree) -> list:
    return [_unstack_bank(r, row) if isinstance(r, list)
            else unstack_layers(r, row)
            for r, row in ((r, tree_map(lambda s, i=i: s[i], stacked))
                           for i, r in enumerate(rows))]


def unstack_layers(example: Tree, stacked: Tree) -> Tree:
    """The inverse of ``stack_layers``: ``stacked`` cut back into the
    per-layer lists of ``example`` (row ``i`` of each bank is layer, or
    group, ``i``)."""
    if isinstance(example, Mapping):
        return {k: _unstack_bank(v, stacked[k]) if _is_bank(k, v)
                else unstack_layers(v, stacked[k])
                for k, v in example.items()}
    if _is_namedtuple(example):
        return type(example)(*(unstack_layers(x, s)
                               for x, s in zip(example, stacked)))
    if isinstance(example, (list, tuple)):
        return type(example)(unstack_layers(x, s)
                             for x, s in zip(example, stacked))
    return stacked
