"""pFedSOP: personalized federated learning with second-order optimization.

Port of ``repro/core/pfedsop.py`` (Sen & Mohan, 2025; equations in
PAPER.md):

per client i at round t
  1. beta   = gompertz(angle(delta_i(t-1), delta(t-1)))          (Eq. 14)
  2. dp     = (1-beta) * delta_i + beta * delta                  (Eq. 15)
  3. step   = [dp dp^T + rho I]^{-1} dp   via Sherman-Morrison   (Eq. 18)
  4. x_it   = x_i(t-1) - eta1 * step                             (Eq. 19)
  5. T-step local SGD from x_it; delta_it = (x0 - xT)/eta2       (Eq. 11)
server
  6. delta_t = mean_i delta_it                                   (Eq. 13)

On the CNN slice, parameters and deltas are flat f32 vectors
(``repro_torch.utils.pytree.FlatLayout``), so every function takes one
client's ``(N,)`` vector or a cohort's ``(C, N)`` block alike: reductions
run over the last axis and per-client scalars broadcast over it.  The LM
slice keeps one client's parameters as a pytree (bf16 at full width) and
runs ``repro``'s per-client round on it, one client at a time
(``tree_client_round`` and the ``tree_*`` functions at the end).

The round-start update (steps 1-4) runs once per round over the whole
gathered cohort: ``round_start`` makes ONE batched call to the kernel
pair (``repro_torch.kernels.pfedsop_update``) on the ``(C, N)`` rows
with the server delta shared as ``(N,)``, then masks with
``torch.where``.  ``repro`` reaches the same launch through a
``custom_vmap`` rule; here the batch axis is written out.  Local SGD
(step 5, ``local_round``) is the per-client part that the engine maps
over the cohort with ``torch.func.vmap``.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.kernels.dispatch import check_impl, current_model_shard, kernel_scope
from repro_torch.kernels.pfedsop_update import ops
from repro_torch.kernels.pfedsop_update.ref import gompertz_beta
from repro_torch.launch import collectives
from repro_torch.optim.reduce import cohort_mean
from repro_torch.optim.sgd import sgd_loop, tree_sgd_loop
from repro_torch.utils.pytree import (
    FlatLayout,
    tree_flatten,
    tree_leaves,
    tree_map,
    tree_unflatten,
)


@dataclass(frozen=True)
class PFedSOPConfig:
    """Hyperparameters (paper Sec. V-B4: rho=1, lambda=1, batch 50, 1 epoch)."""

    eta1: float = 0.01  # personalization learning rate (Eq. 19)
    eta2: float = 0.01  # local-SGD learning rate (Eq. 10)
    rho: float = 1.0  # FIM regularization (Eq. 17)
    lam: float = 1.0  # Gompertz steepness (Eq. 14)
    use_pc: bool = True  # personalization component (ablation Table III)
    eps: float = 1e-12  # cosine-similarity guard
    # async aggregation only: exponent of the polynomial staleness discount
    # composed with the Gompertz weight in ``stale_blend`` (the synchronous
    # driver never sees a stale upload)
    staleness_exp: float = 0.5
    # round-start update implementation (repro_torch.kernels.dispatch):
    # "auto" = CUDA kernel pair on the card, its plain version on the CPU;
    # "reference" = the per-equation math below; "kernel" = CUDA only.
    update_impl: str = "auto"


class ClientState(NamedTuple):
    """Per-client persistent state (flat vectors; stacked (K, ...) at rest)."""

    params: torch.Tensor  # personalized model x_i, (N,)
    delta: torch.Tensor  # latest local gradient update Delta_i, (N,)
    has_delta: torch.Tensor  # bool scalar: False for new clients
    rounds_seen: torch.Tensor  # int32 scalar (diagnostics)


def init_client_state(params) -> ClientState:
    """``params``: a flat vector or a parameter tree."""
    device = tree_leaves(params)[0].device
    return ClientState(
        params=params,
        delta=tree_map(torch.zeros_like, params),
        has_delta=torch.zeros((), dtype=torch.bool, device=device),
        rounds_seen=torch.zeros((), dtype=torch.int32, device=device),
    )


def _dot(a, b):
    return (a.float() * b.float()).sum(-1)


# ---------------------------------------------------------------------------
# Personalized aggregation (Algorithm 1 lines 1-4)
# ---------------------------------------------------------------------------


def gompertz_weight(local_delta, global_delta, lam, eps=1e-12):
    """Aggregation weight beta from the Gompertz-normalized angle.

    Returns (beta, aux); all reductions f32.  A (numerically) zero update
    leaves the angle undefined: theta = pi/2 ("no information")."""
    dot = _dot(local_delta, global_delta)
    nl2 = _dot(local_delta, local_delta)
    ng2 = _dot(global_delta, global_delta).expand_as(dot)
    denom = torch.sqrt(nl2) * torch.sqrt(ng2)
    ok = denom > eps
    sim = torch.where(ok, dot / torch.where(ok, denom, torch.ones_like(denom)),
                      torch.zeros_like(dot))
    sim = torch.clamp(sim, -1.0, 1.0)
    theta = torch.arccos(sim)  # [0, pi]
    beta = 1.0 - torch.exp(-torch.exp(-lam * (theta - 1.0)))  # Eq. 14
    return beta, {"sim": sim, "theta": theta, "beta": beta, "dot": dot,
                  "local_sqnorm": nl2, "global_sqnorm": ng2}


def personalized_delta(local_delta, global_delta, lam, eps=1e-12):
    """Eq. 15: dp = (1-beta) * delta_i + beta * delta."""
    beta, aux = gompertz_weight(local_delta, global_delta, lam, eps)
    b = beta[..., None]
    return (1.0 - b) * local_delta.float() + b * global_delta.float(), aux


def theta_from_beta(beta, lam):
    """Invert Eq. 14: theta = 1 - ln(-ln(1 - beta)) / lam (host numpy,
    diagnostics only), beta clipped away from {0, 1}, theta to [0, pi]."""
    b = np.clip(np.asarray(beta, np.float64), 1e-9, 1.0 - 1e-9)
    theta = 1.0 - np.log(-np.log1p(-b)) / float(lam)
    return np.clip(theta, 0.0, np.pi)


# ---------------------------------------------------------------------------
# Sherman-Morrison second-order step (Algorithm 1 line 5, Eq. 18)
# ---------------------------------------------------------------------------


def sherman_morrison_step(delta_p, rho):
    """F^{-1} dp for F = dp dp^T + rho I, via Sherman-Morrison (Eq. 18).

    step = dp/rho - dp * ||dp||^2 / (rho^2 + rho ||dp||^2)

    Equivalent to dp / (rho + ||dp||^2); the explicit two-term form is
    kept to mirror the paper and ``repro`` (they differ in the last bits
    at large ||dp||, so the port is held to the same form)."""
    sq = _dot(delta_p, delta_p)
    coeff = 1.0 / rho - sq / (rho**2 + rho * sq)
    return (coeff[..., None] * delta_p.float()).to(delta_p.dtype)


def personalize(params, local_delta, global_delta, cfg: PFedSOPConfig):
    """Algorithm 1: (x_it, aux) from (x_i(t-1), Delta_i, Delta).

    ``params``/``local_delta``: (N,) or a cohort's (C, N); ``global_delta``
    (N,).  With ``use_pc`` the fused kernel pair covers the blend and the
    Sherman-Morrison step ("auto"/"kernel"), over the model group's tile
    ranges inside a ``model_shard_axis`` context; "reference" and the no-PC
    ablation run the per-equation math above."""
    impl = check_impl(cfg.update_impl, "pfedsop_update", params)
    if cfg.use_pc and impl != "reference":
        shard = current_model_shard()
        if shard is not None and params.dim() == 2:
            # the engine's model group splits the tiles (cohort-level, outside
            # the vmap, so the collectives are legal)
            fused = functools.partial(ops.pfedsop_update_batched_sharded, group=shard[0],
                                      m=shard[1], comm=collectives)
        elif params.dim() == 2:
            fused = ops.pfedsop_update_batched
        else:
            fused = ops.pfedsop_update
        with kernel_scope("pfedsop_update", impl):
            new, beta = fused(params, local_delta, global_delta, eta1=cfg.eta1,
                              rho=cfg.rho, lam=cfg.lam, eps=cfg.eps, impl=impl)
        return new, {"beta": beta}
    if cfg.use_pc:
        dp, aux = personalized_delta(local_delta, global_delta, cfg.lam, cfg.eps)
    else:
        # ablation: no personalization component -> use the global update
        dp = global_delta.float().expand_as(local_delta)
        aux = {"beta": torch.ones(params.shape[:-1], device=params.device)}
    step = sherman_morrison_step(dp, cfg.rho)
    new = (params.float() - cfg.eta1 * step.float()).to(params.dtype)
    return new, aux


# ---------------------------------------------------------------------------
# Local training (Algorithm 2)
# ---------------------------------------------------------------------------


def local_sgd_delta(loss_fn: Callable, params, batches: Any, eta2: float):
    """T SGD iterations; returns (delta_i, final_params, mean_loss).

    delta_i = (x0 - xT)/eta2 = the sum of the per-iteration gradients
    (Eq. 11/12); multiplied by the reciprocal, as ``repro`` does."""
    final, loss = sgd_loop(loss_fn, params, batches, eta2)
    delta = ((params.float() - final.float()) * (1.0 / eta2)).to(params.dtype)
    return delta, final, loss


# ---------------------------------------------------------------------------
# Client round (Algorithm 3 lines 4-11) and server aggregation
# ---------------------------------------------------------------------------


def round_start(state: ClientState, global_delta, global_has_delta,
                cfg: PFedSOPConfig):
    """The cohort's round-start update (lines 4-7): one batched call over
    the (C, N)-stacked ``state``, then a mask.  New clients
    (has_delta=False) and round 1 (no global update yet) keep their
    stored params; no python branch on a tensor value."""
    can = torch.logical_and(state.has_delta, global_has_delta)
    personalized, aux = personalize(state.params, state.delta, global_delta, cfg)
    params = torch.where(can[..., None], personalized, state.params)
    return state._replace(params=params), {"beta": aux["beta"],
                                           "personalized": can}


def local_round(loss_fn: Callable, state: ClientState, batches,
                cfg: PFedSOPConfig):
    """One client's local phase (lines 8-11) from its round-start params;
    the engine maps it over the cohort."""
    delta, final_params, loss = local_sgd_delta(loss_fn, state.params, batches,
                                                cfg.eta2)
    new_state = ClientState(
        params=final_params,
        delta=delta,
        has_delta=torch.ones_like(state.has_delta),
        rounds_seen=state.rounds_seen + 1,
    )
    return new_state, delta, {"loss": loss}


def client_round(loss_fn: Callable, state: ClientState, global_delta,
                 global_has_delta, batches, cfg: PFedSOPConfig):
    """One pFedSOP round for a (C, N)-stacked cohort: ``round_start`` then
    ``local_round`` mapped over the clients with ``torch.func.vmap``."""
    state, aux = round_start(state, global_delta, global_has_delta, cfg)
    new_state, delta, metrics = torch.func.vmap(
        lambda s, b: local_round(loss_fn, s, b, cfg))(state, batches)
    return new_state, delta, {**metrics, **aux}


def server_aggregate(deltas):
    """Eq. 13: mean over the client axis, canonically associated
    (``repro_torch.optim.reduce.cohort_mean``)."""
    return cohort_mean(deltas)


# ---------------------------------------------------------------------------
# Staleness-weighted aggregation (the async driver, ``repro_torch.fl.async_``)
# ---------------------------------------------------------------------------


def staleness_discount(staleness, exponent):
    """FedBuff-style polynomial discount s(tau) = (1 + tau)^(-exponent), f32.

    tau = 0 gives exactly 1.0 (1^x == 1 in IEEE), so a buffer of fresh
    uploads aggregates bit for bit as the synchronous path does."""
    tau = torch.as_tensor(staleness).to(torch.float32)
    return (1.0 + tau) ** torch.tensor(-exponent, dtype=torch.float32, device=tau.device)


def stale_blend(upload, global_delta, discount, lam, eps=1e-12):
    """Down-blend stale local deltas toward the current global delta.

    ``upload``: one (N,) delta or a buffer's (B, N) rows; ``discount``: the
    matching scalar or (B,) s(tau).  With beta Eq. 14's Gompertz weight:

        c       = (1 - s) * (1 - beta)
        blended = (1 - c) * upload + c * global_delta

    A stale AND conflicting delta is pulled hardest toward the global
    consensus; a fresh upload (s = 1 -> c = 0) passes through bit for bit
    (the select keeps a -0.0 that ``-0.0 + 0 * g`` would turn into +0.0)."""
    beta, _ = gompertz_weight(upload, global_delta, lam, eps)
    c = ((1.0 - discount) * (1.0 - beta))[..., None]
    blended = ((1.0 - c) * upload.float() + c * global_delta.float()).to(upload.dtype)
    return torch.where(c == 0, upload, blended)


# ---------------------------------------------------------------------------
# One client's round on a parameter tree (the LM slice)
# ---------------------------------------------------------------------------


def _tree_dot(a, b):
    """<a, b> over all leaves: per-leaf f32 sums, then their sum (repro's
    ``tree_dot``)."""
    return torch.stack([(x.float() * y.float()).sum()
                        for x, y in zip(tree_leaves(a), tree_leaves(b))]).sum()


def _personalize_tp(params, local_delta, global_delta, cfg, impl, tp, split):
    """The fused update on one model rank's slices: the three trees
    flattened with the split leaves' slices first and the replicated
    leaves after them; K1 over the split prefix on every rank and over the
    replicated tail on rank 0 only (no element counted twice), its tile
    partials zero-padded to rank 0's tile count and gathered in rank order,
    then summed in one fixed order (the same (beta, eta1 coeff) on every
    rank); K2 over every element the rank holds (the replicated leaves come
    out bitwise equal on every rank).  No output gather."""
    leaves = tree_leaves(params)
    order = ([i for i, s in enumerate(split) if s] + [i for i, s in enumerate(split) if not s])
    layout = FlatLayout([leaves[i] for i in order])

    def flat(tree):
        xs = tree_leaves(tree)
        return layout.flatten([xs[i] for i in order])

    xv, dv, gv = flat(params), flat(local_delta), flat(global_delta)
    counted = xv.numel() if tp.rank == 0 else sum(leaves[i].numel() for i in order
                                                   if split[i])
    with kernel_scope("pfedsop_update", impl):
        part = torch.zeros((1, ops.n_tiles(xv.numel()), 3), dtype=torch.float32,
                           device=xv.device)
        if counted:
            part[:, :ops.n_tiles(counted)] = ops.reduce3_batched(dv[None, :counted],
                                                                 gv[:counted])
        parts = collectives.all_gather(part, tp.group, dim=1)
        beta, eta_coeff = ops.scalars_from_partials(parts, cfg.eta1, cfg.rho, cfg.lam,
                                                    cfg.eps)
        new = ops.update_batched(xv[None], dv[None], gv, beta, eta_coeff)[0]
    del xv, dv, gv
    out = [None] * len(leaves)
    for i, x in zip(order, layout.unflatten(new)):
        out[i] = x
    return tree_unflatten(tree_flatten(params)[1], out), {"beta": beta[0],
                                                          "eta_coeff": eta_coeff[0]}


def tree_personalize(params, local_delta, global_delta, cfg: PFedSOPConfig, tp=None,
                     split=None):
    """Algorithm 1 on one client's tree: returns (x_it, aux).

    With ``use_pc`` and "auto"/"kernel", ``repro``'s ``_personalize_fused``:
    flatten the three trees once to f32 vectors, one C = 1 launch pair of
    the fused update, unflatten back to each leaf's dtype.  Inside a
    ``model_shard_axis`` context (a mesh engine's loop-form client phase,
    outside any vmap) the pair runs on this rank's tile range of the one
    row (``pfedsop_update_batched_sharded``, bitwise the whole row's), as
    ``repro`` passes ``shard=current_model_shard()``.  "reference" and the
    no-PC ablation run ``repro``'s per-leaf math, rounding the blend and
    the step to each leaf's dtype as it does.

    ``tp`` (a ``models/parallel.py`` ``TensorParallel``) of more than one
    rank, with ``split`` (a bool per leaf, in leaf order): the trees hold
    this model rank's slices of the ``split`` leaves and the replicated
    leaves whole, as the tensor-parallel train step keeps them; the fused
    update runs on them (``_personalize_tp``): the whole tree's update
    within f32 reduction order."""
    leaf = tree_leaves(params)[0]
    impl = check_impl(cfg.update_impl, "pfedsop_update", leaf)
    if tp is not None and tp.size > 1:
        if not cfg.use_pc or impl == "reference" or split is None:
            raise NotImplementedError(
                "tree_personalize on a model rank's slices runs the fused update with the "
                "personalization component (use_pc, update_impl 'auto' or 'kernel') and "
                "needs ``split``")
        return _personalize_tp(params, local_delta, global_delta, cfg, impl, tp, split)
    if cfg.use_pc and impl != "reference":
        layout = FlatLayout(params)
        xv, dv, gv = (layout.flatten(params), layout.flatten(local_delta),
                      layout.flatten(global_delta))
        shard = current_model_shard()
        with kernel_scope("pfedsop_update", impl):
            if shard is None:
                new, beta = ops.pfedsop_update(xv, dv, gv, cfg.eta1, cfg.rho, cfg.lam,
                                               cfg.eps, impl=impl)
            else:
                new, beta = ops.pfedsop_update_batched_sharded(
                    xv[None], dv[None], gv, group=shard[0], m=shard[1], comm=collectives,
                    eta1=cfg.eta1, rho=cfg.rho, lam=cfg.lam, eps=cfg.eps, impl=impl)
                new, beta = new[0], beta[0]
        del xv, dv, gv
        return layout.unflatten(new), {"beta": beta}
    if cfg.use_pc:
        nl2, ng2 = _tree_dot(local_delta, local_delta), _tree_dot(global_delta, global_delta)
        beta = gompertz_beta(_tree_dot(local_delta, global_delta), nl2, ng2, cfg.lam, cfg.eps)
        dp = tree_map(lambda x, y: ((1.0 - beta) * x.float() + beta * y.float()).to(x.dtype),
                      local_delta, global_delta)
    else:
        dp, beta = global_delta, torch.ones((), device=leaf.device)
    sq = _tree_dot(dp, dp)
    coeff = 1.0 / cfg.rho - sq / (cfg.rho**2 + cfg.rho * sq)
    step = tree_map(lambda x: (coeff * x.float()).to(x.dtype), dp)
    new = tree_map(lambda x, st: (x.float() - cfg.eta1 * st.float()).to(x.dtype), params, step)
    return new, {"beta": beta}


def tree_local_sgd_delta(loss_fn: Callable, params, batches: Any, eta2: float):
    """T SGD iterations on a tree; returns (delta_i, final_params, mean_loss),
    delta_i = (x0 - xT) * (1/eta2) with the difference in the leaf dtype, as
    ``repro``'s ``tree_scale(1/eta2, tree_sub(x0, xT))``."""
    final, loss = tree_sgd_loop(loss_fn, params, batches, eta2)
    delta = tree_map(lambda a, b: ((a - b).float() * (1.0 / eta2)).to(a.dtype),
                     params, final)
    return delta, final, loss


def tree_client_round(loss_fn: Callable, state: ClientState, global_delta,
                      global_has_delta, batches, cfg: PFedSOPConfig):
    """``repro``'s ``client_round`` for ONE client whose params are a tree.

    New clients (has_delta False) and round 1 (no global update yet) skip
    the round-start update.  ``repro`` computes it anyway and selects the
    stored params with ``tree_where``; here the choice is made on the host
    and the update does not run.  Then one of the two deltas is zero, so
    the reported beta is the Gompertz weight of the zero-information angle
    pi/2, the value ``repro`` reports."""
    can = bool(state.has_delta) and bool(global_has_delta)
    if can:
        params, aux = tree_personalize(state.params, state.delta, global_delta, cfg)
    else:
        zero = torch.zeros((), device=state.has_delta.device)
        params = state.params
        aux = {"beta": gompertz_beta(zero, zero, zero, cfg.lam, cfg.eps)
               if cfg.use_pc else torch.ones_like(zero)}
    delta, final, loss = tree_local_sgd_delta(loss_fn, params, batches, cfg.eta2)
    new_state = ClientState(params=final, delta=delta,
                            has_delta=torch.ones_like(state.has_delta),
                            rounds_seen=state.rounds_seen + 1)
    return new_state, delta, {"loss": loss, "beta": aux["beta"], "personalized": can}
