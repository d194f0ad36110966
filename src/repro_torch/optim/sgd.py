"""Gradient entry point of the federated local-SGD phase.

Port of the part of ``repro/optim/sgd.py`` the ported slices run:
``chunked_value_and_grad`` at ``grad_chunks = 1``, which is plain
value-and-grad, and the plain-SGD loop that ``repro`` writes as a
``lax.scan`` in both ``core.baselines.local_train`` and
``core.pfedsop.local_sgd_delta``.  Two forms:

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

from typing import Any, Callable

import torch
import torch.func

from repro_torch.utils.pytree import tree_flatten, tree_unflatten


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


def sgd_loop(loss_fn: Callable, params, batches: Any, lr: float):
    """T plain-SGD steps on a flat parameter vector (Algorithm 2).

    ``batches``: dict of tensors with a leading local-iteration axis T.
    Returns (final_params, mean_loss).  Composes with ``torch.func.vmap``
    over a cohort (a python loop over the static T)."""
    grad_fn = chunked_value_and_grad(loss_fn)
    n_iters = next(iter(batches.values())).shape[0]
    p, losses = params, []
    for t in range(n_iters):
        loss, g = grad_fn(p, {k: v[t] for k, v in batches.items()})
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
