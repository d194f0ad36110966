"""Canonical ordered reductions for bitwise-reproducible aggregation.

Port of ``repro/optim/reduce.py``.  Eq. 13's mean over the client axis
only names a value class unless the association is fixed, and
``torch.sum`` picks its own.  Every cohort reduction therefore goes
through one explicitly associated reduction:

  ``ordered_axis_sum``  top-down binary halving over the leading axis —
                        split n rows into [0, n//2) and [n//2, n), reduce
                        each recursively, add the two partials.

Elementwise f32 adds in the same association give the same bits in
either framework, so ``cohort_mean`` here is bitwise equal to
``repro``'s (tests/test_torch_substrate.py).

For a cohort split over D ranks (D a power of two dividing K'), the top
log2(D) levels of the halving tree split exactly at rank boundaries, so

  tree(K' rows)  ==  tree_over_D_partials( tree(local K'/D rows) )

with identical operands and association on both sides.  Inside a
``client_shard_axis`` context (the engines' sharded aggregation) each
rank computes its local partial, ``all_gather``s the D partials in rank
order and applies the same tree over them: bitwise equal to the
unsharded tree by construction.  ``chunk_mean`` is the same tree over the
gradient chunks of ``optim.sgd.chunked_value_and_grad``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.dispatch import current_client_shard
from repro_torch.launch import collectives
from repro_torch.utils.pytree import tree_map


def is_pow2(n: int) -> bool:
    """True for the client-shard counts whose halving tree aligns with
    shard boundaries (the sharded-aggregation eligibility test)."""
    return n > 0 and (n & (n - 1)) == 0


def ordered_axis_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the leading axis with the canonical halving association."""
    n = x.shape[0]
    if n == 1:
        return x[0]
    h = n // 2
    return ordered_axis_sum(x[:h]) + ordered_axis_sum(x[h:])


def _sharded_sum(x32: torch.Tensor, group) -> torch.Tensor:
    """Local halving-tree partial, then the ordered cross-rank combine:
    the D partials gathered in rank order and summed by the same tree (an
    ``all_reduce`` would leave the cross-rank association to the
    backend)."""
    parts = collectives.all_gather(ordered_axis_sum(x32)[None], group)
    return ordered_axis_sum(parts)


def cohort_size(n_local: int) -> int:
    """The full cohort size K' given the local row count: ``n_local`` per
    rank times the active client-shard count (1 outside any context)."""
    shard = current_client_shard()
    return n_local * (shard[1] if shard is not None else 1)


def cohort_sum(x: torch.Tensor) -> torch.Tensor:
    """Ordered f32 sum over the (possibly client-sharded) leading axis: the
    same halving tree as ``cohort_mean``."""
    shard = current_client_shard()
    x32 = x.float()
    if shard is None:
        return ordered_axis_sum(x32)
    return _sharded_sum(x32, shard[0])


def cohort_mean(tree):
    """Eq. 13's mean over the leading client axis, canonically associated:
    per leaf, the f32 halving-tree sum divided by the FULL cohort size K'
    (the local rows times the client-shard count inside a
    ``client_shard_axis`` context)."""
    shard = current_client_shard()

    def mean(d):
        d32 = d.float()
        if shard is None:
            return ordered_axis_sum(d32) / d.shape[0]
        return _sharded_sum(d32, shard[0]) / (d.shape[0] * shard[1])

    return tree_map(mean, tree)


def chunk_mean(tree):
    """Mean over a leading chunk axis of already-f32 stacked partials (the
    ``grad_chunks`` reduction in ``optim.sgd``): the same halving tree, no
    sharding context."""
    return tree_map(lambda x: ordered_axis_sum(x) / x.shape[0], tree)
