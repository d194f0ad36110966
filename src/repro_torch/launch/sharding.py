"""Sharding rules: param / batch / cache trees -> per-leaf axis specs.

Port of ``repro/launch/sharding.py``.  A spec is a tuple with one entry
per dim of the leaf: a mesh axis name, or None where the dim is not split
(``tuple(P)`` of ``repro``'s ``PartitionSpec``).  Each public function
returns a tree of the input's structure with a spec in place of each leaf.

Megatron-style tensor parallelism on the ``model`` axis, batch parallelism
on ``data``, the FL cohort on the client axis (a leading client axis on
every state leaf).  Rules are name-based with divisibility fallbacks: if
the preferred dim of a leaf is not divisible by the model-axis size the
next candidate is tried, and finally the leaf is replicated; there is no
padding.

Sharded dims by leaf name (unstacked ranks; stacked pattern leaves get a
leading None for the n_rep axis):

  embed (V,D)->V | heads (K,D,V)->V | attn wq (D,H,hd)->H else hd
  wk/wv (D,KV,hd)->KV else hd | attn wo (H,hd,D)->H else hd
  mlp wi* (D,F)->F | mlp wo (F,D)->F | moe wi*/wo (E,..)->E
  ssm in_proj (D,Z)->Z | conv (w,C)->C | out_proj (inner,D)->inner
  norms/router/biases -> replicated

KV caches: batch on ``data``, the cache's sequence dim on ``model``; SSM
decode state: heads on ``model``.

The federation's CNN state is flat ``(K', N)`` rows whose leaf names match
no rule, so its client-stacked specs are the plain client split.

``rank_plan`` turns a spec tree into one rank's plan: per leaf, the
``(dim, slice)`` of every split dim at that rank's coordinates (the
tensor-parallel serving layout, ``models/parallel.py``, and the engines'
placement at rest, ``fl/engine.py::MeshBackend.input_shardings``);
``weights.cut`` applies it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.utils.pytree import tree_flatten, tree_flatten_with_path, tree_unflatten


def _path_names(path):
    return [str(k) for _, k in path]


def _div(n, m):
    return m > 0 and n % m == 0


def _param_rule(names, shape, msize):
    """Returns a tuple of axis-name-or-None of len == len(shape)."""
    name = names[-1]
    spec = [None] * len(shape)

    def try_axes(cands):
        for ax in cands:
            if ax < len(shape) and _div(shape[ax], msize):
                spec[ax] = "model"
                return

    if name == "embed":
        try_axes([len(shape) - 2])  # vocab dim ((V,D) or (K,V,D))
    elif name == "heads":
        try_axes([2])  # (K, D, V) -> vocab
    elif name == "wq":
        try_axes([1, 2])  # (D,H,hd)
    elif name in ("wk", "wv"):
        try_axes([1, 2])  # (D,KV,hd)
    elif name == "wo" and len(shape) == 3 and "attn" in names:
        try_axes([0, 1])  # (H,hd,D)
    elif name in ("wi_gate", "wi_up"):
        if len(shape) == 3:  # moe (E,D,F) -> experts
            try_axes([0])
        else:  # mlp (D,F)
            try_axes([1])
    elif name == "wo":
        if len(shape) == 3:  # moe (E,F,D)
            try_axes([0])
        else:  # mlp (F,D)
            try_axes([0])
    elif name == "in_proj":
        try_axes([1])  # (D, Z)
    elif name == "conv_w":
        try_axes([1])  # (w, C)
    elif name == "conv_b":
        try_axes([0])
    elif name == "out_proj":
        try_axes([0])  # (d_inner, D)
    # norms, router, A_log, dt_bias, D, vis_proj, scale -> replicated
    return tuple(spec)


def _with_prefix(path, leaf, client, client_axis, stacked_prefixes, rule):
    """The leaf's spec: the client axis and the stacked n_rep axis in front
    of ``rule(names, rest of the shape)``."""
    names = _path_names(path)
    shape = list(leaf.shape)
    prefix = []
    if client:
        prefix.append(client_axis)
        shape = shape[1:]
    if names and names[0] in stacked_prefixes:
        prefix.append(None)
        shape = shape[1:]
    return tuple(prefix) + tuple(rule(names, tuple(shape)))


def _specs(tree, spec_of) -> list:
    return [spec_of(p, x) for p, x in tree_flatten_with_path(tree)]


def _as_tree(tree, specs: list):
    """``specs`` (leaf order) in the structure of ``tree``."""
    return tree_unflatten(tree_flatten(tree)[1], specs)


def _param_specs(params_tree, msize, stacked_prefixes=("pattern",), client=False,
                 client_axis=None) -> list:
    return _specs(params_tree, lambda path, leaf: _with_prefix(
        path, leaf, client, client_axis, stacked_prefixes,
        lambda names, shape: _param_rule(names, shape, msize)))


def param_pspecs(params_tree, msize: int, stacked_prefixes=("pattern",),
                 client: bool = False, client_axis: Optional[str] = None):
    """Spec tree matching ``params_tree`` (tensors or meta tensors).

    ``client=True``: every leaf carries a leading FL-client axis, split
    over ``client_axis``.  Leaves under ``pattern`` additionally carry the
    n_rep stack axis (never split)."""
    return _as_tree(params_tree, _param_specs(params_tree, msize, stacked_prefixes,
                                              client, client_axis))


def _cache_rule(names, shape, dsize, msize):
    name = names[-1]
    if name in ("k", "v"):  # (B, cap, KV, hd)
        b, cap = shape[0], shape[1]
        return (
            "data" if _div(b, dsize) else None,
            "model" if _div(cap, msize) else None,
            None,
            None,
        )
    if name in ("k_scale", "v_scale"):  # (B, cap, KV) int8-cache scales
        return (
            "data" if _div(shape[0], dsize) else None,
            "model" if _div(shape[1], msize) else None,
            None,
        )
    if name == "conv":  # (B, w-1, C)
        return (
            "data" if _div(shape[0], dsize) else None,
            None,
            "model" if _div(shape[2], msize) else None,
        )
    if name == "state":  # (B, H, P, N)
        return (
            "data" if _div(shape[0], dsize) else None,
            "model" if _div(shape[1], msize) else None,
            None,
            None,
        )
    return tuple([None] * len(shape))  # pos etc.


def _cache_specs(cache_tree, dsize, msize, stacked_prefixes=("pattern",), client=False,
                 client_axis=None) -> list:
    return _specs(cache_tree, lambda path, leaf: _with_prefix(
        path, leaf, client, client_axis, stacked_prefixes,
        lambda names, shape: _cache_rule(names, shape, dsize, msize)))


def cache_pspecs(cache_tree, dsize: int, msize: int,
                 stacked_prefixes=("pattern",), client: bool = False,
                 client_axis: Optional[str] = None):
    return _as_tree(cache_tree, _cache_specs(cache_tree, dsize, msize, stacked_prefixes,
                                             client, client_axis))


def batch_pspecs(batch_tree, dsize: int, batch_axis_index: int = 0,
                 client: bool = False, client_axis: Optional[str] = None):
    """Split the per-step batch dim on ``data`` (replicate if indivisible).

    ``batch_axis_index`` is the position of the batch dim AFTER the client
    axis (train batches are (T, micro_b, ...) -> index 1)."""
    return _as_tree(batch_tree, _batch_specs(batch_tree, dsize, batch_axis_index, client,
                                             client_axis))


def _batch_specs(batch_tree, dsize, batch_axis_index=0, client=False, client_axis=None) -> list:
    def spec_of(path, leaf):
        shape = list(leaf.shape)
        prefix = []
        if client:
            prefix.append(client_axis)
            shape = shape[1:]
        spec = [None] * len(shape)
        if len(shape) > batch_axis_index and _div(shape[batch_axis_index], dsize):
            spec[batch_axis_index] = "data"
        return tuple(prefix) + tuple(spec)

    return _specs(batch_tree, spec_of)


def client_stacked_specs(tree, axis_name: Optional[str] = "clients",
                        model_axis: Optional[str] = None, msize: int = 1) -> list:
    """Specs (leaf order) splitting the leading stacked-client axis of
    every leaf.

    ``model_axis``/``msize`` compose the per-leaf ``_param_rule`` on top:
    each client's slice additionally splits its Megatron-eligible dims over
    the mesh's model axis.  Leaves whose names match no rule (or whose dims
    are not divisible by ``msize``) stay whole beyond the client axis, so
    arbitrary method state (the CNN federation) composes to the plain
    client split.  The param rules emit the literal axis name ``"model"``,
    so a composing mesh must name its model-role axis ``"model"``."""
    if model_axis is None or msize <= 1:
        return _replicated_specs(tree, client=True, client_axis=axis_name)
    if model_axis != "model":
        raise ValueError(
            f"model-axis composition requires the mesh's model-role axis to "
            f"be named 'model' (got {model_axis!r}); the name-based param "
            "rules emit the literal axis name")
    return _param_specs(tree, msize, client=True, client_axis=axis_name)


def client_stacked_pspecs(tree, axis_name: Optional[str] = "clients",
                          model_axis: Optional[str] = None, msize: int = 1):
    """``client_stacked_specs`` as a tree of ``tree``'s structure."""
    return _as_tree(tree, client_stacked_specs(tree, axis_name, model_axis, msize))


def _replicated_specs(tree, client=False, client_axis=None) -> list:
    def spec_of(path, leaf):
        spec = [None] * len(leaf.shape)
        if client and spec:
            spec[0] = client_axis
        return tuple(spec)

    return _specs(tree, spec_of)


def replicated(tree, client: bool = False, client_axis: Optional[str] = None):
    return _as_tree(tree, _replicated_specs(tree, client, client_axis))



@dataclass(frozen=True)
class LeafPlan:
    """One leaf's part on one rank: ``(dim, slice)`` of each split dim,
    contiguous and in rank order; no cut for a whole leaf."""

    cuts: tuple = ()


def leaf_plan(spec, shape, sizes: dict, ranks: dict) -> LeafPlan:
    """``spec``'s split dims over the axes of ``sizes``, at ``ranks``."""
    cuts = []
    for d, ax in enumerate(spec):
        if ax in sizes and sizes[ax] > 1:
            w = shape[d] // sizes[ax]
            cuts.append((d, slice(ranks[ax] * w, (ranks[ax] + 1) * w)))
    return LeafPlan(tuple(cuts))


def rank_plan(tree, kind: str, dsize: int = 1, msize: int = 1, drank: int = 0,
              mrank: int = 0, client: bool = False):
    """One rank's plan for ``tree`` (tensors or meta tensors): a tree of
    ``LeafPlan``, each the leaf's spec at data rank ``drank`` of ``dsize``
    and model rank ``mrank`` of ``msize``.  ``kind``: "params" (the param
    rules), "caches" (the cache rules) or "batch" (the batch dim first);
    ``client``: every leaf leads with a client axis, never cut here."""
    if kind == "params":
        specs = _param_specs(tree, msize, client=client)
    elif kind == "caches":
        specs = _cache_specs(tree, dsize, msize, client=client)
    elif kind == "batch":
        specs = _batch_specs(tree, dsize, client=client)
    else:
        raise ValueError(f"rank_plan kind {kind!r}: choose params, caches or batch")
    sizes, ranks = {"data": dsize, "model": msize}, {"data": drank, "model": mrank}
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [leaf_plan(sp, x.shape, sizes, ranks)
                                    for x, sp in zip(leaves, specs)])
