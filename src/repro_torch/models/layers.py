"""Shared neural-net building blocks (port of ``repro/models/layers.py``).

Parameters are plain nested dicts of tensors.  Initialisers take an
explicit ``torch.Generator`` and draw on its device (a CUDA generator
fills a full-width model on the card).  Reductions run in f32.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.dispatch import kernel_scope
from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops
from repro_torch.models import parallel


def dense_init(gen, shape, in_axis_size, dtype, scale=1.0):
    """Variance-scaling (fan-in) normal init."""
    std = scale / np.sqrt(max(1, in_axis_size))
    return (torch.randn(shape, generator=gen, device=gen.device) * std).to(dtype)


def embed_init(gen, shape, dtype):
    return (torch.randn(shape, generator=gen, device=gen.device) * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def rmsnorm_init(d, dtype, device):
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}  # (1 + scale)


def rmsnorm(p, x, eps=1e-6, impl="reference"):
    """(1 + scale)-parametrised RMSNorm, f32 reduce.

    ``impl`` is the model-level kernel policy (``ModelConfig.kernel_impl``):
    "reference" runs the plain math, "auto"/"kernel" the fused forward
    kernel K4 (``repro_torch.kernels.rmsnorm``) with the reference's
    autograd for the backward."""
    if impl == "reference":
        return rmsnorm_ops.rmsnorm(x, p["scale"], eps, impl=impl)
    with kernel_scope("rmsnorm", impl):
        return rmsnorm_ops.rmsnorm(x, p["scale"], eps, impl=impl)


def rmsnorm_noscale(x, eps=1e-6):
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope(x, positions, base):
    """Apply rotary embeddings.  x: (..., S, H, hd), hd even; positions (..., S)."""
    hd = x.shape[-1]
    assert hd % 2 == 0, "head_dim must be even for RoPE"
    half = hd // 2
    freqs = base ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions.float()[..., None] * freqs  # (..., S, half)
    sin = torch.sin(ang)[..., None, :]  # broadcast over heads
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = x.float().split(half, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------


def mlp_init(gen, d_model, d_ff, n_layers, dtype):
    return {
        "wi_gate": dense_init(gen, (d_model, d_ff), d_model, dtype),
        "wi_up": dense_init(gen, (d_model, d_ff), d_model, dtype),
        "wo": dense_init(gen, (d_ff, d_model), d_ff, dtype,
                         scale=1.0 / np.sqrt(2 * max(1, n_layers))),
    }


def mlp(p, x, activation="silu", tp=None, d_ff=None):
    """Gated MLP.  With ``tp`` (``models/parallel.py``) and ``wi_*`` / ``wo``
    holding this rank's slice of the ``d_ff`` columns / rows: the
    column-parallel ``wi_*`` read ``x`` through ``parallel.enter`` (its
    gradient summed over the model group), and ``wo`` is row-parallel (its
    partial products summed over the model group)."""
    split = tp is not None and parallel.split(tp, p["wo"].shape[0], d_ff)
    if split:
        x = parallel.enter(x, tp)
    # jax.nn.gelu defaults to the tanh approximation
    g = F.silu(x @ p["wi_gate"]) if activation == "silu" else \
        F.gelu(x @ p["wi_gate"], approximate="tanh")
    h = g * (x @ p["wi_up"])
    if split:
        return parallel.row("...f,fd->...d", h, p["wo"], tp)
    return h @ p["wo"]


def softcap(x, cap):
    return cap * torch.tanh(x / cap)
