"""GQA attention, training and prefill half (port of
``repro/models/attention.py:1-135``).

Grouped-query heads, sliding windows, logit softcapping, optional QK-norm
and per-layer RoPE bases.  ``ModelConfig.kernel_impl`` selects the
implementation of ``attention_fwd``: "reference" runs the blockwise
q-block loop below (``repro``'s ``lax.scan``, with the score tensor at
(B, q_block, KV, G, S)); "auto"/"kernel" run the flash kernels K5-K7
(``repro_torch.kernels.flash_gqa``), whose masks assume the canonical
positions arange(S) that every model entry point passes.  The kernels
tile by their own sizes, so ``q_block`` only shapes the reference loop.

The decode path and its ring-buffer KV caches (``repro``'s ``:143-244``)
come with the serving slice (ROADMAP.md queue 1, item 15).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.dispatch import check_impl_name, kernel_scope
from repro_torch.kernels.flash_gqa import ops as flash_ops
from repro_torch.models.layers import dense_init, rmsnorm, rmsnorm_init, rope, softcap

NEG_INF = -1e30


def attn_init(gen, cfg, dtype):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(gen, (d, h, hd), d, dtype),
        "wk": dense_init(gen, (d, kv, hd), d, dtype),
        "wv": dense_init(gen, (d, kv, hd), d, dtype),
        "wo": dense_init(gen, (h, hd, d), h * hd, dtype,
                         scale=1.0 / np.sqrt(2 * max(1, cfg.n_layers))),
    }
    if cfg.use_qk_norm:
        p["q_norm"] = rmsnorm_init(hd, dtype, gen.device)
        p["k_norm"] = rmsnorm_init(hd, dtype, gen.device)
    return p


def _project_qkv(p, cfg, x, positions, rope_base):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.use_qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps, impl=cfg.kernel_impl)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps, impl=cfg.kernel_impl)
    return rope(q, positions, rope_base), rope(k, positions, rope_base), v


def _grouped_scores(q, k, cfg):
    """q: (B,Sq,H,hd), k: (B,Sk,KV,hd) -> scores (B,Sq,KV,G,Sk) in f32.

    ``repro`` keeps bf16 operands with f32 accumulation; bf16 products are
    exact in f32, so f32 operands give the same sums."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, sq, kv, h // kv, hd)
    s = torch.einsum("bqkgd,btkd->bqkgt", qg.float(), k.float()) * (hd**-0.5)
    if cfg.attn_softcap is not None:
        s = softcap(s, cfg.attn_softcap)
    return s


def attention_fwd(p, cfg, x, positions, window, rope_base, q_block=512):
    """Training / prefill self-attention (causal, optional sliding window).

    x: (B,S,D) already layer-normed; positions: (B,S) int32."""
    b, s, d = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = _project_qkv(p, cfg, x, positions, rope_base)

    if check_impl_name(cfg.kernel_impl, "flash_gqa") != "reference":
        with kernel_scope("flash_gqa", cfg.kernel_impl):
            o = flash_ops.flash_gqa(q, k, v, window=window, softcap=cfg.attn_softcap,
                                    impl=cfg.kernel_impl)
        return torch.einsum("bshk,hkd->bsd", o.to(x.dtype), p["wo"])

    qb = min(q_block, s)
    while s % qb:
        qb //= 2
    outs = []
    for i in range(s // qb):
        qi = q[:, i * qb:(i + 1) * qb]  # (B,qb,H,hd)
        qpos = positions[:, i * qb:(i + 1) * qb]
        sc = _grouped_scores(qi, k, cfg)  # (B,qb,KV,G,S)
        mask = positions[:, None, :] <= qpos[:, :, None]  # causal (B,qb,S)
        if window is not None:
            mask &= (qpos[:, :, None] - positions[:, None, :]) < window
        sc = torch.where(mask[:, :, None, None, :], sc, NEG_INF)
        w = torch.softmax(sc, dim=-1)
        # probabilities cast to the storage dtype for the PV product, f32 sums
        o = torch.einsum("bqkgt,btkd->bqkgd", w.to(v.dtype).float(), v.float())
        outs.append(o.reshape(b, qb, h, hd).to(x.dtype))
    return torch.einsum("bshk,hkd->bsd", torch.cat(outs, dim=1), p["wo"])
