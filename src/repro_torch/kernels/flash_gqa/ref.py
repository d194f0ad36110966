"""Plain PyTorch oracle for flash_gqa (port of
``repro/kernels/flash_gqa/ref.py``): causal GQA attention with optional
sliding window and logit softcap.  Materialises the full score matrix —
only usable at test sizes.  Takes the model layout (B, S, H, D) that
``repro.kernels.flash_gqa.ops.flash_gqa`` takes.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def visible_mask(s: int, window, device) -> torch.Tensor:
    """(S, S) bool: key j visible to query i (j <= i, i - j < window)."""
    qi = torch.arange(s, device=device)[:, None]
    kj = torch.arange(s, device=device)[None, :]
    mask = kj <= qi
    if window is not None:
        mask &= (qi - kj) < window
    return mask


def flash_gqa_ref(q, k, v, window=None, softcap=None, scale=None):
    """q: (B,S,H,D), k/v: (B,S,KV,D) -> (B,S,H,D).  Causal."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    sc = scale if scale is not None else d**-0.5
    qg = q.float().reshape(b, s, kv, h // kv, d)
    scores = torch.einsum("bqkgd,btkd->bkgqt", qg, k.float()) * sc
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    scores = scores.masked_fill(~visible_mask(s, window, q.device), NEG_INF)
    w = torch.softmax(scores, dim=-1)
    o = torch.einsum("bkgqt,btkd->bqkgd", w, v.float())
    return o.reshape(b, s, h, d).to(q.dtype)
