"""Plain PyTorch oracle for the fused pFedSOP round-start update.

Port of ``repro/kernels/pfedsop_update/ref.py``.
``pfedsop_update_batched_ref`` is the oracle over a leading client axis,
written as a batch dimension (the server delta may be shared as
``(N,)``); one client is the ``C = 1`` case.
"""
from __future__ import annotations

import torch


def gompertz_beta(dot, nl2, ng2, lam, eps=1e-12):
    """Eq. 14 from the three reductions.  ``denom <= eps`` (a zero delta,
    e.g. round 1) gives sim = 0, theta = pi/2.  Clamped before arccos."""
    denom = torch.sqrt(nl2) * torch.sqrt(ng2)
    ok = denom > eps
    sim = torch.where(ok, dot / torch.where(ok, denom, torch.ones_like(denom)),
                      torch.zeros_like(dot))
    theta = torch.arccos(torch.clamp(sim, -1.0, 1.0))
    return 1.0 - torch.exp(-torch.exp(-lam * (theta - 1.0)))


def coeff_from_sums(dot, nl2, ng2, beta, rho):
    """eta-free Sherman-Morrison coefficient from the three reductions:
    ||dp||^2 is a quadratic form of (dot, nl2, ng2), so no fourth sweep."""
    sq = (1.0 - beta) ** 2 * nl2 + 2.0 * beta * (1.0 - beta) * dot + beta**2 * ng2
    return 1.0 / rho - sq / (rho**2 + rho * sq)


def pfedsop_update_batched_ref(x, delta_i, delta_g, eta1, rho, lam, eps=1e-12):
    """x/delta_i: (C, N); delta_g: (C, N) or (N,) shared.
    Returns (x_new (C, N) in x's dtype, beta (C,) f32)."""
    di = delta_i.float()
    dg = delta_g.float()
    dot = (di * dg).sum(-1)
    nl2 = (di * di).sum(-1)
    ng2 = (dg * dg).sum(-1).expand_as(dot)
    beta = gompertz_beta(dot, nl2, ng2, lam, eps)
    b = beta[:, None]
    dp = (1.0 - b) * di + b * dg
    coeff = coeff_from_sums(dot, nl2, ng2, beta, rho)
    x_new = (x.float() - (eta1 * coeff)[:, None] * dp).to(x.dtype)
    return x_new, beta
