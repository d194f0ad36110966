"""Pytree helpers over nested dicts / tuples / lists / NamedTuples of tensors.

The leaf order is ``jax.tree.leaves`` order (``repro/utils/pytree.py``):
dict keys sorted, tuples and lists positional, NamedTuples positional.
That order fixes the flat parameter vector, so the port's flat client
state lines up element for element with ``repro``'s
``tree_flatten_to_vector`` (for the CNN: ``blocks[i].{conv1, conv2,
gn1.bias, gn1.scale, gn2.bias, gn2.scale, proj}``, then ``fc_b``,
``fc_w``, ``stem``, ``stem_gn.bias``, ``stem_gn.scale``).

The federation keeps each client's parameters as ONE flat f32 row of a
``(K, N)`` buffer; ``FlatLayout.unflatten`` hands the model per-leaf
views of a row (or of a stacked ``(C, N)`` block), so no flatten or
unflatten copy is made per round.
"""
from __future__ import annotations

from typing import Any, Callable, List, Sequence, Tuple

import torch

Pytree = Any


def tree_flatten(tree: Pytree) -> Tuple[List[Any], Any]:
    """(leaves in jax order, treedef)."""
    leaves: List[Any] = []

    def rec(x):
        if isinstance(x, dict):
            keys = sorted(x)
            return (dict, keys, [rec(x[k]) for k in keys])
        if isinstance(x, (tuple, list)):  # NamedTuples included
            return (type(x), None, [rec(v) for v in x])
        leaves.append(x)
        return None

    return leaves, rec(tree)


def tree_unflatten(treedef, leaves: Sequence[Any]) -> Pytree:
    it = iter(leaves)

    def rec(node):
        if node is None:
            return next(it)
        kind, keys, children = node
        if kind is dict:
            return {k: rec(c) for k, c in zip(keys, children)}
        vals = [rec(c) for c in children]
        if issubclass(kind, tuple) and hasattr(kind, "_fields"):
            return kind(*vals)
        return kind(vals)

    return rec(treedef)


def tree_leaves(tree: Pytree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_flatten_with_path(tree: Pytree) -> List[Tuple[tuple, Any]]:
    """[(path, leaf)] in leaf order.  A path is a tuple of keys, each
    ``("dict", key)``, ``("seq", index)`` or ``("attr", field)`` (a
    NamedTuple field), as ``jax.tree_util``'s DictKey, SequenceKey and
    GetAttrKey."""
    out: List[Tuple[tuple, Any]] = []

    def rec(x, path):
        if isinstance(x, dict):
            for k in sorted(x):
                rec(x[k], path + (("dict", k),))
        elif isinstance(x, tuple) and hasattr(x, "_fields"):
            for f, v in zip(x._fields, x):
                rec(v, path + (("attr", f),))
        elif isinstance(x, (tuple, list)):
            for i, v in enumerate(x):
                rec(v, path + (("seq", i),))
        else:
            out.append((path, x))

    rec(tree, ())
    return out


def keystr(path: tuple) -> str:
    """A path joined with "/" as ``"/".join(str(k) for k in path)`` over
    ``jax.tree_util`` keys reads: ``['name']``, ``[0]``, ``.field``."""
    fmt = {"dict": lambda k: f"[{k!r}]", "seq": lambda i: f"[{i}]",
           "attr": lambda f: f".{f}"}
    return "/".join(fmt[kind](k) for kind, k in path)


def tree_map(fn: Callable, tree: Pytree, *rest: Pytree) -> Pytree:
    """``fn`` over the leaves of ``tree`` (and, zipped, of same-structured
    ``rest`` trees)."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_leaves(r) for r in rest]
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])


def tree_stack(trees: Sequence[Pytree]) -> Pytree:
    """Stack same-structured trees leaf by leaf on a new leading axis."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


class FlatLayout:
    """Where each leaf of a parameter tree lives in the flat vector.

    Built once from a template tree.  ``flatten`` concatenates a tree's
    leaves (as f32) into ``(N,)``; ``unflatten`` splits a ``(..., N)`` tensor
    back into leaves of shape ``(..., *leaf_shape)`` in the template's leaf
    dtypes — one ``torch.split``, whose backward is a single concatenation,
    so a gradient taken through it lands in one flat ``(..., N)`` buffer.
    Leaves whose dtype is the vector's are views (an f32 template, as the
    CNN's, gets views of the f32 rows); others are cast copies (a bf16
    model gets its leaves back as bf16, as ``repro``'s
    ``tree_unflatten_from_vector`` does).  Works inside ``torch.func.vmap``.
    """

    def __init__(self, template: Pytree):
        leaves, self.treedef = tree_flatten(template)
        self.paths = [keystr(p) for p, _ in tree_flatten_with_path(template)]
        self.shapes = [tuple(x.shape) for x in leaves]
        self.dtypes = [x.dtype for x in leaves]
        self.sizes = [int(x.numel()) for x in leaves]
        self.size = sum(self.sizes)

    def leaf_mask(self, predicate: Callable[[str], bool], device=None) -> torch.Tensor:
        """(N,) f32 0/1 vector: 1 over the leaves whose path string
        (``keystr``, e.g. ``['fc_w']``) satisfies ``predicate``."""
        return torch.cat([torch.full((n,), 1.0 if predicate(p) else 0.0, device=device)
                          for p, n in zip(self.paths, self.sizes)])

    def flatten(self, tree: Pytree) -> torch.Tensor:
        return torch.cat([x.float().reshape(-1) for x in tree_leaves(tree)])

    def unflatten(self, vec: torch.Tensor) -> Pytree:
        lead = tuple(vec.shape[:-1])
        parts = vec.split(self.sizes, dim=-1)
        return tree_unflatten(
            self.treedef,
            [p.reshape(lead + s).to(dt) for p, s, dt in zip(parts, self.shapes, self.dtypes)])
