"""Plain PyTorch oracle for flash_gqa (port of
``repro/kernels/flash_gqa/ref.py``): causal GQA attention with optional
sliding window and logit softcap.  Materialises the full score matrix —
only usable at test sizes.  Takes the model layout (B, S, H, D) that
``repro.kernels.flash_gqa.ops.flash_gqa`` takes.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def visible_mask(s: int, window, device, q0: int = 0, sq=None) -> torch.Tensor:
    """(Sq, S) bool: key j visible to query i (j <= i, i - j < window), the
    Sq queries at positions q0 .. q0 + Sq - 1 (``sq`` None: S - q0)."""
    sq = s - q0 if sq is None else sq
    qi = torch.arange(q0, q0 + sq, device=device)[:, None]
    kj = torch.arange(s, device=device)[None, :]
    mask = kj <= qi
    if window is not None:
        mask &= (qi - kj) < window
    return mask


def flash_gqa_ref(q, k, v, window=None, softcap=None, scale=None, q0=None):
    """q: (B,Sq,H,D), k/v: (B,S,KV,D) -> (B,Sq,H,D).  Causal; the queries
    at positions q0 .. q0 + Sq - 1 (``q0`` None: Sq = S, no offset)."""
    b, sq, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    if q0 is None and sq != s:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} hold different "
                         "positions and no query offset was given")
    q0 = q0 or 0
    sc = scale if scale is not None else d**-0.5
    qg = q.float().reshape(b, sq, kv, h // kv, d)
    scores = torch.einsum("bqkgd,btkd->bkgqt", qg, k.float()) * sc
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    scores = scores.masked_fill(~visible_mask(s, window, q.device, q0, sq), NEG_INF)
    w = torch.softmax(scores, dim=-1)
    o = torch.einsum("bkgqt,btkd->bqkgd", w, v.float())
    return o.reshape(b, sq, h, d).to(q.dtype)
