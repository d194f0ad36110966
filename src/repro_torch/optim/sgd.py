"""Gradient entry point of the federated local-SGD phase.

Port of the part of ``repro/optim/sgd.py`` this slice runs:
``chunked_value_and_grad`` at ``grad_chunks = 1``, which is plain
value-and-grad, and the plain-SGD loop that ``repro`` writes as a
``lax.scan`` in both ``core.baselines.local_train`` and
``core.pfedsop.local_sgd_delta``.  The chunk-tree reduction
(``grad_chunks > 1``) and the data-axis layout come with the
multi-device slice (ROADMAP.md queue 1).
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.func


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
