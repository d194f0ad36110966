"""Tensor-parallel (Megatron) ops: what one rank of the model axis computes
when it holds its model slice of every Megatron-eligible leaf
(``launch/sharding.py``'s rules) and, serving, its data rank's rows of the
batch and the KV caches.

``repro`` gets this layout from GSPMD: its prefill and decode steps are
``jax.jit``'d with params and caches sharded over ``model`` and batches
over ``data`` (``repro/launch/dryrun.py``), and its train step
(``repro/launch/train.py``) with the client state and the global delta
sharded over ``model``; the partitioner inserts the collectives, forward
and backward.  The port writes the per-rank program out.  A
``TensorParallel`` carries the groups; every op takes it as an argument
(never a global), and is called only where a dim is split.

Every op is differentiable: each collective is a ``torch.autograd.
Function`` that runs out of place, with its conjugate as its backward
(Megatron's "f" and "g"):

  ``enter``          identity forward; SUM all-reduce of the gradient.  A
                     tensor whole on every rank that feeds computation
                     split over the model ranks gets a per-rank partial
                     gradient there, so it passes through ``enter`` at
                     that point, after every replicated computation
                     (whose replicated leaves then take the whole
                     gradient): a column-parallel projection's input, the
                     slice a rank takes of a whole tensor (its heads, its
                     conv channels, its experts' gates), a replicated
                     leaf read on split data (QK-norm scales on a rank's
                     heads, the SSM's per-head leaves);
  ``row``            a row-parallel projection: this rank's partial
                     product over its slice of the contracted dim, in the
                     activation dtype (f32 accumulation inside the
                     matmul), then a SUM all-reduce over the model group
                     in that dtype, as XLA reduces GSPMD's partials;
                     identity backward (the whole gradient is on every
                     rank);
  ``reduce``         that SUM all-reduce alone (identity backward);
  ``gather``         a column-parallel output made whole along ``dim``
                     (all-gather in rank order); backward: this rank's
                     slice of the gradient (after an ``enter``, a
                     reduce-scatter);
  ``sum_f32``        a SUM all-reduce of f32 partials (the MoE combines,
                     whose sums over the experts the whole model takes
                     in f32 before the cast);
  ``rms_noscale``    the scale-free RMSNorm of a vector split over the
                     model group (the SSM's gated norm over ``d_inner``
                     with the heads split): the rank's f32 sum of squares
                     all-reduced, then divided by the whole length; the
                     statistic feeds each rank's own heads, so its
                     backward is an all-reduce too (``reduce``, then
                     ``enter``);
  ``vocab_embed``    the embedding lookup on a vocab slice: ids outside it
                     give zero rows, then a SUM all-reduce (exact: one
                     nonzero term a position);
  ``cross_entropy``  the mean next-token CE from this rank's vocab slice
                     of the logits, the (B, S, V) logits never gathered:
                     the global max over the slices' maxima (gathered in
                     rank order), a SUM all-reduce of the slice's f32
                     ``sum(exp(l - M))`` and the gold logit from its
                     owner (masked, then summed);
  ``vocab_argmax``   greedy tokens from vocab-sliced logits: each rank's
                     max and its first index, all-gathered in rank order,
                     and the first rank holding the largest max wins, so
                     ties go to the lowest global index, as ``argmax`` on
                     the whole logits does;
  ``rows_before``    the sum of a per-rank count over the data ranks
                     before this one (whose batch rows come first): the
                     MoE dispatch's slot positions over the whole batch;
  ``codebook_embed`` the audio frontend's summed codebook embeddings from
                     vocab slices of its (K, V, D) tables: one
                     ``vocab_embed`` a codebook, summed in codebook order
                     (``x = 0; x + e_0 + e_1 ...``), as the whole model;
  ``combine_attention``  one query's attention over slot slices: each
                     rank's max, sum of exponentials and weighted V,
                     all-gathered in rank order and combined in that
                     order (the flash-decoding combine).

Results are bitwise from run to run, and every rank's copy of a whole
tensor (a replicated leaf's gradient included) bitwise the others': gathers
keep rank order, every combine runs in a fixed order, and the SUM
all-reduce is the backend's fixed algorithm, whose result every rank
receives.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch.launch import collectives


@dataclass(frozen=True)
class TensorParallel:
    """One rank's place in a tensor-parallel layout: the model
    group (``size`` ranks, this one ``rank``) and the data group (its
    ``data_size`` ranks each hold ``1 / data_size`` of the batch rows, in
    data-rank order; ``launch/steps.py`` drops the data group where the
    size does not divide the batch).  ``None`` groups are the default
    process group."""

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


class _Reduce(torch.autograd.Function):
    """SUM all-reduce forward (out of place), identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return collectives.all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Enter(torch.autograd.Function):
    """Identity forward, SUM all-reduce of the gradient backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return collectives.all_reduce(g.clone(), ctx.group), None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` in rank order forward, this rank's slice of
    the gradient backward."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.dim, ctx.n = dim, x.shape[dim]
        ctx.lo = collectives.rank(group) * x.shape[dim]
        return collectives.all_gather(x, group, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.lo, ctx.n), None, None


def _active(tp: Optional[TensorParallel]) -> bool:
    return tp is not None and tp.size > 1


def enter(x: torch.Tensor, tp: Optional[TensorParallel]) -> torch.Tensor:
    """``x``, whole on every rank, where split computation reads it: the
    identity, whose backward sums the ranks' partial gradients."""
    return _Enter.apply(x, tp.group) if _active(tp) else x


def reduce(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """Every model rank's partial ``x`` summed, in ``x``'s dtype."""
    return _Reduce.apply(x, tp.group)


def gather(x: torch.Tensor, tp: TensorParallel, dim: int) -> torch.Tensor:
    """Every model rank's slice of ``x`` concatenated along ``dim``."""
    return _Gather.apply(x, tp.group, dim % x.dim())


def row(eq: str, x: torch.Tensor, w: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """``einsum(eq, x, w)`` whose contracted dim is split over the model
    group: this rank's partial product, summed over the group, both in
    ``x``'s dtype."""
    return reduce(torch.einsum(eq, x, w), tp)


def sum_f32(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """Every model rank's f32 partial ``x`` summed, in f32."""
    if x.dtype != torch.float32:
        raise TypeError(f"sum_f32 reduces f32 partials, got {x.dtype}")
    return reduce(x, tp)


def rms_noscale(x: torch.Tensor, tp: TensorParallel, whole: int,
                eps: float = 1e-6) -> torch.Tensor:
    """``layers.rmsnorm_noscale`` over a last dim of ``whole`` of which
    ``x`` holds this rank's share: the mean square is the f32 sum of
    squares over every rank, divided by ``whole``."""
    x32 = x.float()
    ss = enter(reduce((x32 * x32).sum(dim=-1, keepdim=True), tp), tp)
    return (x32 * torch.rsqrt(ss / whole + eps)).to(x.dtype)


def rows_before(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """The sum of ``x`` over the data ranks before this one."""
    parts = collectives.all_gather(x.unsqueeze(0), tp.data_group, dim=0)
    return parts[:tp.data_rank].sum(0)


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
    return reduce(rows * inside[..., None].to(rows.dtype), tp)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  tp: TensorParallel) -> torch.Tensor:
    """``transformer.cross_entropy`` (the mean CE in f32) from this rank's
    vocab slice ``logits`` (..., V/m) of the vocab: logsumexp as the
    gathered max ``M`` plus the log of the summed slices'
    ``sum(exp(l - M))``, the gold logit from the rank that holds it."""
    logits = logits.float()
    n = logits.shape[-1]
    with torch.no_grad():  # logsumexp does not depend on M
        top = collectives.all_gather(logits.amax(-1).unsqueeze(0), tp.group, dim=0).amax(0)
    se = reduce(torch.exp(logits - top[..., None]).sum(-1), tp)
    local = labels.long() - tp.rank * n
    inside = (local >= 0) & (local < n)
    gold = logits.gather(-1, local.clamp(0, n - 1)[..., None])[..., 0]
    gold = reduce(torch.where(inside, gold, torch.zeros_like(gold)), tp)
    return (torch.log(se) + top - gold).mean()


def codebook_embed(tokens: torch.Tensor, emb: torch.Tensor, tp: TensorParallel,
                   vocab: int) -> torch.Tensor:
    """``sum_k F.embedding(tokens[:, k], whole[k])`` in codebook order, from
    this rank's vocab rows ``emb`` (K, V/m, D) of (K, ``vocab``, D) tables;
    ``tokens`` (B, K, S)."""
    x = 0
    for k in range(emb.shape[0]):
        x = x + vocab_embed(tokens[:, k], emb[k], tp, vocab)
    return x


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
