"""GQA attention (port of ``repro/models/attention.py``): the training and
prefill path, and the single-token decode path with ring-buffer KV caches.

Grouped-query heads, sliding windows, logit softcapping, optional QK-norm
and per-layer RoPE bases.  ``ModelConfig.kernel_impl`` selects the
implementation of ``attention_fwd``: "reference" runs the blockwise
q-block loop below (``repro``'s ``lax.scan``, with the score tensor at
(B, q_block, KV, G, S)); "auto"/"kernel" run the flash kernels K5-K7
(``repro_torch.kernels.flash_gqa``), whose masks assume the canonical
positions arange(S) that every model entry point passes.  The kernels
tile by their own sizes, so ``q_block`` only shapes the reference loop.

Decode stays on plain ATen ops (einsums and a softmax), as ``repro``'s
stays on ``jnp``: one query token against a ring buffer is bound by the
bytes of the cache, not a tiled matmul.  Its caches are written in place
(slot ``pos % capacity``), where ``repro`` returns updated arrays.
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
    q, k, v = _project_qkv(p, cfg, x, positions, rope_base)
    return _attend(p, cfg, q, k, v, positions, window, x.dtype, q_block)


def _attend(p, cfg, q, k, v, positions, window, dtype, q_block):
    """``attention_fwd`` after the projections: the mixing and the output
    projection, the result in ``dtype``."""
    b, s, h, hd = q.shape
    if check_impl_name(cfg.kernel_impl, "flash_gqa") != "reference":
        with kernel_scope("flash_gqa", cfg.kernel_impl):
            o = flash_ops.flash_gqa(q, k, v, window=window, softcap=cfg.attn_softcap,
                                    impl=cfg.kernel_impl)
        return torch.einsum("bshk,hkd->bsd", o.to(dtype), p["wo"])

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
        outs.append(o.reshape(b, qb, h, hd).to(dtype))
    return torch.einsum("bshk,hkd->bsd", torch.cat(outs, dim=1), p["wo"])


# ---------------------------------------------------------------------------
# Decode path (single new token against a KV cache)
# ---------------------------------------------------------------------------


def init_cache(cfg, batch, capacity, dtype, device):
    """An empty ring buffer of ``capacity`` slots on ``device``; ``pos``
    holds each slot's absolute position (-1 = empty)."""
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    pos = torch.full((capacity,), -1, dtype=torch.int32, device=device)
    if cfg.kv_quant:
        # int8 symmetric per-(token, kv-head) quantisation: half the bytes
        # of a bf16 cache
        return {
            "k": torch.zeros((batch, capacity, kv, hd), dtype=torch.int8, device=device),
            "v": torch.zeros((batch, capacity, kv, hd), dtype=torch.int8, device=device),
            "k_scale": torch.zeros((batch, capacity, kv), dtype=torch.bfloat16, device=device),
            "v_scale": torch.zeros((batch, capacity, kv), dtype=torch.bfloat16, device=device),
            "pos": pos,
        }
    return {"k": torch.zeros((batch, capacity, kv, hd), dtype=dtype, device=device),
            "v": torch.zeros((batch, capacity, kv, hd), dtype=dtype, device=device),
            "pos": pos}


def _quantize(x):
    """x: (..., hd) -> (int8 values, bf16 scale over the last dim).  The
    scale is max(amax / 127, 1e-8) in f32; ``torch.round`` rounds half to
    even, as ``jnp.round``."""
    x32 = x.float()
    scale = torch.clamp(x32.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def _write_slot(buf, slot, value):
    """buf[:, slot] = value[:, 0] in place; ``slot`` an int or a (1,) tensor."""
    if isinstance(slot, int):
        buf[:, slot] = value[:, 0]
    else:
        buf.index_copy_(1, slot, value)


def attention_decode(p, cfg, x, pos, cache, window, rope_base):
    """Decode one token.

    x: (B,1,D) normed hidden; pos: the absolute position, a Python int or a
    0-d integer tensor (no host sync either way); cache: a ring buffer
    (capacity W for windowed layers, the sequence budget for full ones),
    updated in place at slot ``pos % capacity``.  Returns (out (B,1,D),
    cache)."""
    b = x.shape[0]
    h, hd = cfg.n_heads, cfg.head_dim
    if not isinstance(pos, torch.Tensor):
        pos = int(pos)
    if isinstance(pos, torch.Tensor):
        positions = pos.to(device=x.device, dtype=torch.int32).reshape(1, 1).expand(b, 1)
    else:
        positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(p, cfg, x, positions, rope_base)

    cap = cache["k"].shape[1]
    slot = pos % cap if isinstance(pos, int) else (positions[:1, 0] % cap).long()
    if isinstance(slot, int):
        cache["pos"][slot] = pos
    else:
        cache["pos"].index_copy_(0, slot, positions[:1, 0])
    slot_pos = cache["pos"]
    if "k_scale" in cache:  # int8 cache: quantise the new token on write
        for name, new in (("k", k_new), ("v", v_new)):
            qv, sc = _quantize(new)
            _write_slot(cache[name], slot, qv)
            _write_slot(cache[name + "_scale"], slot, sc)
        # dequantised in x's dtype, as repro does
        k = cache["k"].to(x.dtype) * cache["k_scale"][..., None].to(x.dtype)
        v = cache["v"].to(x.dtype) * cache["v_scale"][..., None].to(x.dtype)
    else:
        _write_slot(cache["k"], slot, k_new.to(cache["k"].dtype))
        _write_slot(cache["v"], slot, v_new.to(cache["v"].dtype))
        k, v = cache["k"], cache["v"]

    sc = _grouped_scores(q, k, cfg)  # (B,1,KV,G,cap)
    cur = positions[0, 0]
    valid = (slot_pos >= 0) & (slot_pos <= cur)
    if window is not None:
        valid &= (cur - slot_pos) < window
    sc = torch.where(valid[None, None, None, None, :], sc, NEG_INF)
    w = torch.softmax(sc, dim=-1)
    # probabilities cast to the storage dtype for the PV product, f32 sums
    o = torch.einsum("bqkgt,btkd->bqkgd", w.to(v.dtype).float(), v.float())
    o = o.reshape(b, 1, h, hd).to(x.dtype)
    return torch.einsum("bshk,hkd->bsd", o, p["wo"]), cache


def pack_prefill_cache(cfg, k, v, positions, capacity, dtype):
    """Full-sequence post-RoPE k/v (B,S,KV,hd) -> the ring-buffer cache that
    decode expects: slot(p) = p % capacity, keeping the last ``capacity``
    positions (all of them when capacity >= S)."""
    b, s = k.shape[0], k.shape[1]
    cap = capacity or s  # >= s for full-attention layers, so decode does not
    #                      wrap onto the prompt
    take = min(cap, s)
    last_pos = positions[0, -take:].to(torch.int32)
    slots = (last_pos % cap).long()
    cache = init_cache(cfg, b, cap, dtype, k.device)
    kk, vv = k[:, -take:], v[:, -take:]
    if cfg.kv_quant:
        for name, x in (("k", kk), ("v", vv)):
            qv, sc = _quantize(x)
            cache[name].index_copy_(1, slots, qv)
            cache[name + "_scale"].index_copy_(1, slots, sc)
    else:
        cache["k"].index_copy_(1, slots, kk.to(dtype))
        cache["v"].index_copy_(1, slots, vv.to(dtype))
    cache["pos"].index_copy_(0, slots, last_pos)
    return cache
