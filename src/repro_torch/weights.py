"""Carry parameter trees between ``repro`` (JAX) and the port.

Both packages use the same nested-dict layout (``repro_torch.models.cnn``
keeps JAX's HWIO conv weights; ``repro_torch.models.transformer`` keeps
the stacked ``pattern`` tuples), so a tree moves across as numpy leaves:
``params_from_jax(jax.tree.map(np.asarray, params), device)`` here, and
``params_to_numpy`` back.  ``jax.random`` init bits cannot be reproduced
in torch, so parity tests carry ``repro``'s initialization across.

A JAX bfloat16 leaf arrives as an ``ml_dtypes.bfloat16`` array, which
``torch.from_numpy`` refuses; it crosses as its 16-bit pattern
(an ``int16`` view, reinterpreted as ``torch.bfloat16``), so every bit is
kept.  Back in numpy a bfloat16 leaf comes out as float32, which holds
every bfloat16 value exactly.

``cut`` takes one rank's slices of a tree (a whole tree or one carried
across from ``repro``) by a ``launch/sharding.py::rank_plan``: the
params, caches and batch of a tensor-parallel serving rank, the client
state and global delta of a tensor-parallel train step.  ``join`` is its
inverse over the ranks that hold the slices: the whole leaves, gathered
in rank order.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import tree_map


def _tensor(x) -> torch.Tensor:
    a = np.array(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(tree, device="cuda"):
    """Tree of numpy arrays (same structure as ``repro``'s) -> tensors."""
    dev = resolve_device(device)
    return tree_map(lambda x: _tensor(x).to(dev), tree)


def params_to_numpy(tree):
    """Tensors -> numpy; bfloat16 leaves as exact float32."""
    def leaf(x):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return tree_map(leaf, tree)



def _cut_leaf(x, plan, own):
    for d, sl in plan.cuts:
        x = x.narrow(d, sl.start, sl.stop - sl.start)
    return x.clone() if own or plan.cuts else x


def cut(tree, plan, own: bool = True):
    """``tree`` cut to one rank's slices by ``plan`` (a ``rank_plan``
    tree of ``LeafPlan``).  ``own``: every leaf in a storage of its own
    (a whole leaf cloned too), so the whole tree can be freed."""
    return tree_map(lambda x, p: _cut_leaf(x, p, own), tree, plan)


def join(tree, plan, gather):
    """The whole leaves of ``tree`` (this rank's slices, cut by ``plan``)
    from every rank's: ``gather(x, dim)`` returns every rank's ``x``
    concatenated along ``dim`` in rank order (``launch/collectives.py::
    all_gather`` over the group the cut dims split), called on every rank
    for every cut dim, innermost cut first; uncut leaves come back as
    they are."""
    def leaf(x, p):
        for d, _ in reversed(p.cuts):
            x = gather(x, d)
        return x
    return tree_map(leaf, tree, plan)
