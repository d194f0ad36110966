"""Plain PyTorch oracle for the rmsnorm kernel (port of
``repro/kernels/rmsnorm/ref.py``)."""
from __future__ import annotations

import torch


def rmsnorm_ref(x, scale, eps: float = 1e-6):
    """x: (..., D); scale: (D,).  (1+scale) parametrisation, f32 reduce."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)
