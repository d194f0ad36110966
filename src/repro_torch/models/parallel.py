"""Tensor-parallel (Megatron) serving ops: what one rank of the model axis
computes when it holds its model slice of every Megatron-eligible leaf
(``launch/sharding.py``'s rules) and its data rank's rows of the batch and
the KV caches.

``repro`` gets this layout from GSPMD: its prefill and decode steps are
``jax.jit``'d with params and caches sharded over ``model`` and batches
over ``data`` (``repro/launch/dryrun.py``), and the partitioner inserts
the collectives.  The port writes the per-rank program out.  A
``TensorParallel`` carries the groups; every op takes it as an argument
(never a global), and is called only where a dim is split.

  ``row``            a row-parallel projection: this rank's partial
                     product over its slice of the contracted dim, in the
                     activation dtype (f32 accumulation inside the
                     matmul), then a SUM all-reduce over the model group
                     in that dtype, as XLA reduces GSPMD's partials;
  ``gather``         a column-parallel output made whole along ``dim``
                     (all-gather in rank order);
  ``vocab_embed``    the embedding lookup on a vocab slice: ids outside it
                     give zero rows, then a SUM all-reduce (exact: one
                     nonzero term a position);
  ``vocab_argmax``   greedy tokens from vocab-sliced logits: each rank's
                     max and its first index, all-gathered in rank order,
                     and the first rank holding the largest max wins, so
                     ties go to the lowest global index, as ``argmax`` on
                     the whole logits does;
  ``combine_attention``  one query's attention over slot slices: each
                     rank's max, sum of exponentials and weighted V,
                     all-gathered in rank order and combined in that
                     order (the flash-decoding combine).

A column-parallel projection needs no op: it is the local matmul on the
local slice of the weight.  Results are bitwise from run to run: gathers
keep rank order, every combine runs in a fixed order, and the SUM
all-reduce is the backend's fixed algorithm.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch.launch import collectives


@dataclass(frozen=True)
class TensorParallel:
    """One rank's place in a tensor-parallel serving layout: the model
    group (``size`` ranks, this one ``rank``) and the data group (its
    ``data_size`` ranks each hold ``1 / data_size`` of the batch rows).
    ``None`` groups are the default process group."""

    group: Any = None
    size: int = 1
    rank: int = 0
    data_group: Any = None
    data_size: int = 1
    data_rank: int = 0

    def slice_of(self, n: int) -> slice:
        """This model rank's contiguous share of ``n`` (``n`` divides)."""
        w = n // self.size
        return slice(self.rank * w, (self.rank + 1) * w)


def split(tp: Optional[TensorParallel], local: int, whole: int) -> bool:
    """Whether a dim of ``whole`` holds only this rank's ``local`` share."""
    if local == whole:
        return False
    if tp is None or local * tp.size != whole:
        raise ValueError(f"a dim of {local} is neither whole ({whole}) nor one of "
                         f"{1 if tp is None else tp.size} model slices")
    return True


def gather(x: torch.Tensor, tp: TensorParallel, dim: int) -> torch.Tensor:
    """Every model rank's slice of ``x`` concatenated along ``dim``."""
    return collectives.all_gather(x, tp.group, dim=dim % x.dim())


def row(eq: str, x: torch.Tensor, w: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """``einsum(eq, x, w)`` whose contracted dim is split over the model
    group: this rank's partial product, summed over the group, both in
    ``x``'s dtype."""
    return collectives.all_reduce(torch.einsum(eq, x, w), tp.group)


def vocab_embed(tokens: torch.Tensor, emb: torch.Tensor, tp: TensorParallel,
                vocab: int) -> torch.Tensor:
    """``F.embedding(tokens, whole)`` from this rank's rows ``emb`` of a
    ``vocab``-row table."""
    if not split(tp, emb.shape[0], vocab):
        return torch.nn.functional.embedding(tokens, emb)
    lo = tp.rank * emb.shape[0]
    local = tokens.long() - lo
    inside = (local >= 0) & (local < emb.shape[0])
    rows = torch.nn.functional.embedding(local.clamp(0, emb.shape[0] - 1), emb)
    return collectives.all_reduce(rows * inside[..., None].to(rows.dtype), tp.group)


def vocab_argmax(logits: torch.Tensor, tp: TensorParallel, vocab: int) -> torch.Tensor:
    """``argmax(-1)`` of the whole logits from this rank's vocab slice."""
    if not split(tp, logits.shape[-1], vocab):
        return logits.argmax(-1)
    best, idx = logits.float().max(-1)  # the first index of the slice's max
    idx = idx + tp.rank * logits.shape[-1]
    best = gather(best.unsqueeze(0), tp, 0)  # (m, ...) in rank order
    idx = gather(idx.unsqueeze(0), tp, 0)
    # the first rank holding the largest max: the lowest global index
    return idx.gather(0, best.argmax(0, keepdim=True))[0]


def combine_attention(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor,
                      tp: TensorParallel) -> torch.Tensor:
    """The softmax-weighted V over every rank's slots from each rank's part:
    ``m`` its max score (..., 1), ``l`` its sum of ``exp(s - m)`` (..., 1),
    ``o`` its ``exp(s - m)``-weighted V (..., hd), all f32.  Combined in
    rank order: sum_r exp(m_r - M) o_r / sum_r exp(m_r - M) l_r."""
    parts = gather(torch.cat([m, l, o], dim=-1).unsqueeze(0), tp, 0)
    ms, ls, os_ = parts[..., :1], parts[..., 1:2], parts[..., 2:]
    top = ms.amax(0)
    num = den = 0
    for r in range(tp.size):  # rank order
        a = torch.exp(ms[r] - top)
        num = num + a * os_[r]
        den = den + a * ls[r]
    return num / den
