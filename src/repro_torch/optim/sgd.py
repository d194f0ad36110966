"""Gradient entry point of the federated local-SGD phase, and the
first-order optimizers.

Port of ``repro/optim/sgd.py``: ``chunked_value_and_grad`` at
``grad_chunks = 1``, which is plain value-and-grad; the optimizers as
``(init_fn, update_fn)`` pairs over tensors or trees of tensors
(``update_fn(grads, state, params) -> (updates, new_state)``, applied with
``apply_updates``; moments in f32 whatever the parameter dtype, updates
added in f32 and cast back to the leaf dtype); and the plain-SGD loop that
``repro`` writes as a ``lax.scan`` in both ``core.baselines.local_train``
and ``core.pfedsop.local_sgd_delta``.  The loop has two forms:

  ``sgd_loop``       one flat parameter vector, through ``torch.func`` so
                     the CNN slice maps it over the cohort with ``vmap``;
  ``tree_sgd_loop``  one client's parameter tree, through
                     ``torch.autograd.grad`` on leaf tensors (the LM slice:
                     its CUDA kernels read ``data_ptr()``, which
                     ``torch.func``'s wrapped tensors refuse, and
                     ``torch.utils.checkpoint`` does not run under
                     ``torch.func``).

The chunk-tree reduction (``grad_chunks > 1``) and the data-axis layout
come with the multi-device slice (ROADMAP.md queue 1).
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Tuple

import torch
import torch.func

from repro_torch.utils.pytree import tree_flatten, tree_map, tree_unflatten

Optimizer = Tuple[Callable, Callable]


def chunked_value_and_grad(loss_fn: Callable, grad_chunks: int = 1) -> Callable:
    """``fn(params, batch) -> (loss, grad)`` through ``torch.func``, so it
    composes with ``torch.func.vmap`` over the cohort."""
    if grad_chunks != 1:
        raise NotImplementedError(
            f"grad_chunks={grad_chunks}: only the plain gradient "
            "(grad_chunks=1) is ported; see ROADMAP.md queue 1"
        )
    grad_and_value = torch.func.grad_and_value(loss_fn)

    def fn(params, batch):
        grad, loss = grad_and_value(params, batch)
        return loss, grad

    return fn


def sgd_loop(loss_fn: Callable, params, batches: Any, lr: float, mask=None, prox=None):
    """T plain-SGD steps on a flat parameter vector (Algorithm 2).

    ``batches``: dict of tensors with a leading local-iteration axis T.
    ``mask``: a 0/1 (N,) vector freezing parameters (FedRep); ``prox``:
    (mu, ref), the FedProx/Ditto proximal term mu/2 ||x - ref||^2 added to
    the objective.  Returns (final_params, mean_loss).  Composes with
    ``torch.func.vmap`` over a cohort (a python loop over the static T)."""
    if prox is not None:
        mu, ref = prox
        data_loss = loss_fn

        def loss_fn(p, batch):
            d = p.float() - ref.float()
            return data_loss(p, batch) + 0.5 * mu * (d * d).sum()

    grad_fn = chunked_value_and_grad(loss_fn)
    n_iters = next(iter(batches.values())).shape[0]
    p, losses = params, []
    for t in range(n_iters):
        loss, g = grad_fn(p, {k: v[t] for k, v in batches.items()})
        if mask is not None:
            g = g * mask
        p = (p.float() - lr * g.float()).to(p.dtype)
        losses.append(loss)
    return p, torch.stack(losses).mean()


def tree_sgd_loop(loss_fn: Callable, params, batches: Any, lr: float):
    """T plain-SGD steps on one parameter tree, each leaf updated as
    ``(x.f32 - lr * g.f32)`` cast back to its dtype, as ``repro`` does.

    ``batches``: dict of tensors with a leading local-iteration axis T.
    Returns (final_params, mean_loss)."""
    leaves, treedef = tree_flatten(params)
    n_iters = next(iter(batches.values())).shape[0]
    losses = []
    for t in range(n_iters):
        req = [x.detach().requires_grad_() for x in leaves]
        loss = loss_fn(tree_unflatten(treedef, req), {k: v[t] for k, v in batches.items()})
        grads = torch.autograd.grad(loss, req)
        with torch.no_grad():
            leaves = [(x.float() - lr * g.float()).to(x.dtype) for x, g in zip(req, grads)]
        losses.append(loss.detach())
        del req, grads, loss
    return tree_unflatten(treedef, leaves), torch.stack(losses).mean()


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p.float() + u.float()).to(p.dtype), params, updates)


def sgd(lr: float) -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params=None):
        return tree_map(lambda g: -lr * g.float(), grads), state

    return init, update


def momentum(lr: float, beta: float = 0.9, nesterov: bool = False) -> Optimizer:
    def init(params):
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)

    def update(grads, state, params=None):
        m = tree_map(lambda v, g: beta * v + g.float(), state, grads)
        if nesterov:
            upd = tree_map(lambda v, g: -lr * (beta * v + g.float()), m, grads)
        else:
            upd = tree_map(lambda v: -lr * v, m)
        return upd, m

    return init, update


class AdamState(NamedTuple):
    mu: Any
    nu: Any
    count: torch.Tensor


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    """``lr`` may be a float or a schedule ``step -> lr`` (e.g.
    ``cosine_schedule``), called with the int32 step count."""

    def init(params):
        z = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        leaf = tree_flatten(params)[0][0]
        return AdamState(tree_map(z, params), tree_map(z, params),
                         torch.zeros((), dtype=torch.int32, device=leaf.device))

    def update(grads, state, params=None):
        count = state.count + 1
        lr_t = lr(count) if callable(lr) else lr
        c = count.float()
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(), state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g.float().square(), state.nu, grads)
        mu_hat = tree_map(lambda m: m / (1 - b1 ** c), mu)
        nu_hat = tree_map(lambda v: v / (1 - b2 ** c), nu)
        upd = tree_map(lambda m, v: -lr_t * m / (torch.sqrt(v) + eps), mu_hat, nu_hat)
        if weight_decay and params is not None:
            upd = tree_map(lambda u, p: u - lr_t * weight_decay * p.float(), upd, params)
        return upd, AdamState(mu, nu, count)

    return init, update


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """Linear warmup to ``base_lr`` over ``warmup`` steps, then a cosine
    decay to 0 at ``total``; ``step`` is a tensor, the result f32."""

    def sched(step):
        step = step.float()
        warm = base_lr * step / max(1, warmup)
        frac = torch.clamp((step - warmup) / max(1, total - warmup), 0.0, 1.0)
        cos = 0.5 * base_lr * (1.0 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)

    return sched
