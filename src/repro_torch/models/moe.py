"""Mixture-of-experts FFN block, OLMoE / granite-MoE style (port of
``repro/models/moe.py``).

Three interchangeable implementations, selected by ``impl``
(``ModelConfig.moe_impl``):

``dense``             every expert processes every token; the router
                      weights zero out the non-selected experts (the
                      default; E/k times the active work);
``dispatch``          capacity-based scatter/gather: tokens go into an
                      (E, capacity, D) buffer, each expert runs its FFN over
                      its buffer, results are gathered back and combined
                      with the router probabilities; overflow is dropped
                      (GShard semantics);
``dispatch_grouped``  the same with every batch row its own routing group
                      (group-local positions and capacity).

Router: linear (f32) -> top-k -> softmax over the selected logits, plus
the Switch load-balance aux loss.  The top-k follows ``jax.lax.top_k``'s
order: values descending, ties broken by the lower index (a stable
descending sort).  Where ``repro`` scatter-adds with ``mode="drop"``, the
dropped slots' contributions are zeroed before the add, so the buffer
receives exact zeros there, as in ``repro``.

Tensor-parallel serving (``tp``, a ``models/parallel.py``
``TensorParallel``): the experts are split over the model group where
their count divides (``launch/sharding.py``: ``wi_gate``/``wi_up``/``wo``
on E), the router is whole on every rank, so the routing, the top-k
weights, the aux loss and the capacity (from the whole E) are the whole
model's.  A rank runs its E/m experts: ``dense`` on every token, the
dispatches on the slots routed to its experts only (the others are
masked to exact zeros, as the dropped slots are).  It sums its weighted
outputs in f32 and the ranks' partials are summed in f32
(``parallel.sum_f32``) before the cast, where the whole model sums over
every expert (``dense``) or slot (the dispatches) in f32: the same
terms, in another order.  Where the batch rows are split over the data
group, ``dispatch`` routes over the whole batch, as the whole model: the
capacity from every row's tokens, and each slot's position in its
expert's buffer offset by the slots the earlier data ranks' rows route
to that expert (``parallel.rows_before``).  The aux loss is this data
rank's rows' (serving discards it).  Training, the tokens and the gates
a rank's experts read enter through ``parallel.enter`` (their gradients
summed over the model group; the router's own gradient, from the aux
loss and the gates, is then the whole model's on every rank).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import parallel
from repro_torch.models.layers import dense_init


def moe_init(gen, cfg, dtype):
    d, e, f = cfg.d_model, cfg.n_experts, cfg.expert_ff
    return {
        "router": dense_init(gen, (d, e), d, torch.float32),  # router math in f32
        "wi_gate": dense_init(gen, (e, d, f), d, dtype),
        "wi_up": dense_init(gen, (e, d, f), d, dtype),
        "wo": dense_init(gen, (e, f, d), f, dtype, scale=1.0 / np.sqrt(2 * max(1, cfg.n_layers))),
    }


def _top_k(logits, k):
    """``jax.lax.top_k``: the k largest along the last axis, descending,
    the lower index first among equal values."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _router(p, cfg, x):
    """x: (N, D) -> (weights (N, E) f32, zero at the non-selected experts;
    top_idx (N, k); top_w (N, k) f32; aux loss)."""
    e, k = cfg.n_experts, cfg.top_k
    logits = x.float() @ p["router"]  # (N, E)
    top_vals, top_idx = _top_k(logits, k)
    top_w = torch.softmax(top_vals, dim=-1)  # normalized over the selected
    onehot = F.one_hot(top_idx, e).float()  # (N, k, E)
    weights = torch.einsum("nk,nke->ne", top_w, onehot)
    # Switch-style load-balance aux loss: E * sum_e f_e * P_e
    probs = torch.softmax(logits, dim=-1)
    frac_tokens = onehot.sum(dim=1).mean(dim=0)  # f_e
    frac_prob = probs.mean(dim=0)  # P_e
    aux = e * (frac_tokens * frac_prob).sum()
    return weights, top_idx, top_w, aux


def _expert_ffn(p, xs):
    """xs: (E, C, D) -> (E, C, D); SwiGLU batched over the expert axis."""
    g = F.silu(torch.einsum("ecd,edf->ecf", xs, p["wi_gate"]))
    u = torch.einsum("ecd,edf->ecf", xs, p["wi_up"])
    return torch.einsum("ecf,efd->ecd", g * u, p["wo"])


def _experts(p, cfg, tp):
    """This rank's experts ``lo .. lo + n - 1`` as (lo, n), or None where
    it holds all of them."""
    n = p["wi_gate"].shape[0]
    if tp is None or not parallel.split(tp, n, cfg.n_experts):
        return None
    return tp.rank * n, n


def _gates(w, tp):
    """The router's whole gates as this rank's experts read them: their
    gradient summed over the model group (``parallel.enter``)."""
    return parallel.enter(w, tp)


def _combine(out, x, tp, mine):
    """The f32 partial sum ``out`` summed over the model group where the
    experts are split, then cast to ``x``'s dtype."""
    if mine is not None:
        out = parallel.sum_f32(out, tp)
    return out.to(x.dtype)


def _own_slots(expert_of, keep, mine):
    """(expert index into this rank's weights, kept) of each slot: with
    ``mine`` (lo, n), a slot routed elsewhere is dropped here and indexes
    a local expert, clamped, with a zero contribution."""
    if mine is None:
        return expert_of, keep
    lo, n = mine
    local = expert_of - lo
    return local.clamp(0, n - 1), keep & (local >= 0) & (local < n)


def moe_dense(p, cfg, x, tp=None):
    """Every expert on every token.  x: (B,S,D) -> ((B,S,D), aux)."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    weights, _, _, aux = _router(p, cfg, xf)
    mine = _experts(p, cfg, tp)
    if mine is not None:  # the whole tokens and gates, read by this rank's experts
        weights = _gates(weights, tp)[:, mine[0]:mine[0] + mine[1]]
        xf = parallel.enter(xf, tp)
    g = F.silu(torch.einsum("nd,edf->enf", xf, p["wi_gate"]))
    u = torch.einsum("nd,edf->enf", xf, p["wi_up"])
    y = torch.einsum("enf,efd->end", g * u, p["wo"])  # (E, N, D)
    out = torch.einsum("end,ne->nd", y.float(), weights)
    return _combine(out, x, tp, mine).reshape(b, s, d), aux


def _capacity(n, k, e, factor):
    """ceil(n k / e * factor), rounded up to a multiple of 8, at least 8."""
    cap = int(np.ceil(n * k / e * factor))
    return max(8, int(np.ceil(cap / 8) * 8))


def moe_dispatch(p, cfg, x, tp=None):
    """Capacity-based scatter/gather dispatch.  x: (B,S,D) -> ((B,S,D), aux).
    A slot past its expert's capacity adds nothing for that expert."""
    b, s, d = x.shape
    n = b * s
    e, k = cfg.n_experts, cfg.top_k
    xf = x.reshape(n, d)
    _, top_idx, top_w, aux = _router(p, cfg, xf)
    rows_split = tp is not None and tp.data_size > 1
    cap = _capacity(n * (tp.data_size if rows_split else 1), k, e, cfg.capacity_factor)

    # position of each (token, slot) in its expert's buffer: the running
    # count of earlier slots routed to the same expert, in token order
    expert_of = top_idx.reshape(n * k)  # (T,), T = N k slots
    onehot = F.one_hot(expert_of, e)  # (T, E)
    pos = (onehot.cumsum(dim=0) * onehot).sum(dim=-1) - 1
    if rows_split:  # the earlier data ranks' slots come first
        pos = pos + parallel.rows_before(onehot.sum(dim=0), tp)[expert_of]
    mine = _experts(p, cfg, tp)
    expert_of, keep = _own_slots(expert_of, pos < cap, mine)
    pos_c = torch.where(keep, pos, cap - 1)  # clamped; dropped slots add zeros
    if mine is not None:
        xf, top_w = parallel.enter(xf, tp), _gates(top_w, tp)

    token_of = torch.arange(n * k, device=x.device) // k
    contrib = xf[token_of] * keep[:, None].to(xf.dtype)  # (T, D)
    xs = torch.zeros((p["wi_gate"].shape[0], cap, d), dtype=xf.dtype,
                     device=x.device).index_put((expert_of, pos_c), contrib, accumulate=True)

    ys = _expert_ffn(p, xs)  # (E, cap, D)
    back = ys[expert_of, pos_c]  # (T, D)
    comb_w = top_w.reshape(n * k) * keep.float()
    out = (back.float() * comb_w[:, None]).reshape(n, k, d).sum(dim=1)
    return _combine(out, x, tp, mine).reshape(b, s, d), aux


def _positions_sorted(expert_of, e):
    """Position of each slot in its expert's buffer, by a stable sort.

    expert_of: (G, T) -> (G, T) int64: within each row, the count of
    earlier slots (in slot order) routed to the same expert."""
    t = expert_of.shape[-1]
    order = torch.argsort(expert_of, dim=-1, stable=True)  # slots grouped by expert
    sorted_e = expert_of.gather(-1, order)
    experts = torch.arange(e, device=expert_of.device).expand(expert_of.shape[0], e)
    # index of the first slot of each expert's run
    run_start = torch.searchsorted(sorted_e.contiguous(), experts.contiguous(), side="left")
    pos_sorted = torch.arange(t, device=expert_of.device) - run_start.gather(-1, sorted_e)
    # back to slot order
    return torch.empty_like(pos_sorted).scatter_(-1, order, pos_sorted)


def moe_dispatch_grouped(p, cfg, x, tp=None):
    """Group-local capacity dispatch: every batch row is its own routing
    group, cap_g = ceil(S k / E * capacity_factor) (rounded as above)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    _, top_idx, top_w, aux = _router(p, cfg, x.reshape(b * s, d))
    g, n_g = b, s  # one group per batch row
    cap = _capacity(n_g, k, e, cfg.capacity_factor)

    expert_of = top_idx.reshape(g, n_g * k)  # (G, T_g)
    pos = _positions_sorted(expert_of, e)
    mine = _experts(p, cfg, tp)
    expert_of, keep = _own_slots(expert_of, pos < cap, mine)
    pos_c = torch.where(keep, pos, cap - 1)
    if mine is not None:
        x, top_w = parallel.enter(x, tp), _gates(top_w, tp)

    token_of = torch.arange(n_g * k, device=x.device) // k  # token index in its group
    contrib = x[:, token_of, :] * keep[..., None].to(x.dtype)  # (G, T_g, D)
    rows = torch.arange(g, device=x.device)[:, None].expand(g, n_g * k)
    xs = torch.zeros((g, p["wi_gate"].shape[0], cap, d), dtype=x.dtype,
                     device=x.device).index_put((rows, expert_of, pos_c), contrib,
                                                accumulate=True)

    gg = F.silu(torch.einsum("gecd,edf->gecf", xs, p["wi_gate"]))
    uu = torch.einsum("gecd,edf->gecf", xs, p["wi_up"])
    ys = torch.einsum("gecf,efd->gecd", gg * uu, p["wo"])  # (G, E, cap, D)

    back = ys[rows, expert_of, pos_c]  # (G, T_g, D)
    comb_w = top_w.reshape(g, n_g * k) * keep.float()
    out = (back.float() * comb_w[..., None]).reshape(g, n_g, k, d).sum(dim=2)
    return _combine(out, x, tp, mine), aux


def moe_ffn(p, cfg, x, impl: str = "dense", tp=None):
    if impl == "dense":
        return moe_dense(p, cfg, x, tp)
    if impl == "dispatch":
        return moe_dispatch(p, cfg, x, tp)
    if impl == "dispatch_grouped":
        return moe_dispatch_grouped(p, cfg, x, tp)
    raise ValueError(f"unknown moe impl {impl!r}")
