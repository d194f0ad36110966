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
``repro``'s (tests/test_torch_substrate.py).  The client-shard contexts
of the multi-device layouts are not ported yet (ROADMAP.md queue 1).
"""
from __future__ import annotations

import torch

from repro_torch.utils.pytree import tree_map


def ordered_axis_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the leading axis with the canonical halving association."""
    n = x.shape[0]
    if n == 1:
        return x[0]
    h = n // 2
    return ordered_axis_sum(x[:h]) + ordered_axis_sum(x[h:])


def cohort_sum(x: torch.Tensor) -> torch.Tensor:
    """Ordered f32 sum over the leading (client) axis: the same halving
    tree as ``cohort_mean``."""
    return ordered_axis_sum(x.float())


def cohort_mean(tree):
    """Eq. 13's mean over the leading client axis, canonically associated:
    per leaf, the f32 halving-tree sum divided by the cohort size."""
    return tree_map(lambda d: ordered_axis_sum(d.float()) / d.shape[0], tree)
