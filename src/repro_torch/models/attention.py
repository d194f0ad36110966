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

Tensor parallelism (``tp``, a ``models/parallel.py``
``TensorParallel``), serving and training: each rank holds its model slice of ``wq``/``wk``/
``wv``/``wo`` by ``launch/sharding.py``'s rules (heads where they divide,
else ``head_dim``) and its slice of every KV cache's slots (batch rows
over ``data``, slots over ``model``; ``pos`` whole).  The split of each
projection is read from the local weight's shape:

- a projection split on ``head_dim`` is all-gathered over the model
  group straight after its matmul: QK-norm, RoPE and QKᵀ need whole
  ``head_dim``; a projection split on heads stays local;
- prefill: this rank's query heads attend (K5) to the KV heads they
  read: its own KV heads, or, where ``wk``/``wv`` split ``head_dim``
  (gemma3-1b's one KV head at m = 2), the gathered KV heads' share its
  query heads need (K5 at G = H_local / KV_local); the cache needs every
  KV head, so head-split K/V are gathered for it, and the prompt's
  last ``capacity`` positions are copied straight into this rank's
  slots;
- decode: the query and the new K/V are made whole; only the rank that
  owns slot ``pos % capacity`` writes it (a masked write, no host
  sync); every rank attends its own slots for every head, and the
  partials combine in rank order (``parallel.combine_attention``);
- the int8 cache (``kv_quant``): ``k_scale``/``v_scale`` split on slots
  with ``k``/``v``; the owner writes the quantised values and their
  scales; prefill quantises this rank's slots from whole heads (the
  quantisation acts over ``head_dim`` per token and head, so the pieces
  are the whole cache's bits); decode dequantises this rank's slots;
- ``wo`` is row-parallel on the dim its rule splits: the attention
  output is cut to match, and the partial products are summed over the
  model group.

Under autograd (the tensor-parallel train step) the gradient of a whole
tensor read by split computation is a per-rank partial, summed by
``parallel.enter`` at the point of the split: the block input of the
projections that hold a slice (``_block_input``, one all-reduce of the
gradient a block), whole K/V (gathered over ``head_dim``, after the
replicated QK-norm and RoPE) where this rank's query heads read their
share (``_whole_kv``), a whole attention output cut for ``wo``, and the
QK-norm scales where they act on this rank's heads; a gather's backward
is this rank's slice of the gradient.

Where the port's collectives differ from what GSPMD would insert into
``repro``'s partitioned step (its HLO cannot be read here): the port
gathers head-split K/V for the cache and whole queries for decode, where
GSPMD is free to reshard with an all-to-all or to keep the cache
head-split; decode's combine gathers each rank's
(max, sum, weighted V) once, where GSPMD partitions the softmax's max
and sum as two all-reduces and the weighted V as a third.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.dispatch import check_impl_name, kernel_scope
from repro_torch.kernels.flash_gqa import ops as flash_ops
from repro_torch.models import parallel
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


def _split_w(w, heads, cfg, tp):
    """Whether a projection (D, heads, hd) holds a slice (heads or hd)."""
    return tp is not None and (parallel.split(tp, w.shape[1], heads)
                               or parallel.split(tp, w.shape[2], cfg.head_dim))


def _project(x, w, cfg, tp):
    """x @ w (D, heads, hd), whole ``head_dim`` (gathered where split)."""
    y = torch.einsum("bsd,dhk->bshk", x, w)
    if tp is not None and parallel.split(tp, w.shape[2], cfg.head_dim):
        y = parallel.gather(y, tp, -1)
    return y


def _qk_norm(p, cfg, x, heads, tp):
    """QK-norm; its replicated scale read on this rank's heads passes
    through ``parallel.enter`` (its gradient summed over the ranks)."""
    scale = p["scale"]
    if tp is not None and parallel.split(tp, x.shape[2], heads):
        scale = parallel.enter(scale, tp)
    return rmsnorm({"scale": scale}, x, cfg.norm_eps, impl=cfg.kernel_impl)


def _block_input(x, tp):
    """The block input as the column-parallel projections read it: its
    gradient summed over the model group (``parallel.enter``)."""
    return parallel.enter(x, tp)


def _whole_kv(k, v, tp):
    """Whole K/V as this rank's query heads read them (``parallel.enter``)."""
    return parallel.enter(k, tp), parallel.enter(v, tp)


def _project_qkv(p, cfg, x, positions, rope_base, tp=None):
    """q, k, v after QK-norm and RoPE.  A projection holding a slice reads
    the block input through one ``parallel.enter``."""
    heads = {"wq": cfg.n_heads, "wk": cfg.n_kv_heads, "wv": cfg.n_kv_heads}
    split = {n: _split_w(p[n], h, cfg, tp) for n, h in heads.items()}
    xe = _block_input(x, tp) if any(split.values()) else x
    q, k, v = (_project(xe if split[n] else x, p[n], cfg, tp) for n in heads)
    if cfg.use_qk_norm:
        q = _qk_norm(p["q_norm"], cfg, q, cfg.n_heads, tp)
        k = _qk_norm(p["k_norm"], cfg, k, cfg.n_kv_heads, tp)
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


def attention_fwd(p, cfg, x, positions, window, rope_base, q_block=512, tp=None):
    """Training / prefill self-attention (causal, optional sliding window).

    x: (B,S,D) already layer-normed; positions: (B,S) int32."""
    q, k, v = _project_qkv(p, cfg, x, positions, rope_base, tp)
    return _attend(p, cfg, q, k, v, positions, window, x.dtype, q_block, tp)


def _heads(x, n, tp):
    """Whole heads (dim 2) of ``n``, gathered where ``x`` holds a slice."""
    if tp is not None and parallel.split(tp, x.shape[2], n):
        return parallel.gather(x, tp, 2)
    return x


def _kv_for_queries(cfg, q, k, v, tp):
    """The K/V heads this rank's query heads read: its own head slice, or
    that slice's share of whole K/V heads (module docstring)."""
    h, kv = cfg.n_heads, cfg.n_kv_heads
    if not parallel.split(tp, q.shape[2], h):
        return _heads(k, kv, tp), _heads(v, kv, tp)
    if parallel.split(tp, k.shape[2], kv):
        return k, v  # heads split alike on both sides
    qs, g = tp.slice_of(h), h // kv
    lo, hi = qs.start // g, (qs.stop - 1) // g + 1
    if (qs.stop - qs.start) % (hi - lo):
        raise NotImplementedError(f"{qs.stop - qs.start} query heads a rank do not group "
                                  f"evenly over {hi - lo} KV heads")
    k, v = _whole_kv(k, v, tp)
    return k[:, :, lo:hi], v[:, :, lo:hi]


def _out_proj(p, cfg, o, tp):
    """o (B,S,heads,hd) @ wo; row-parallel on the dim ``wo``'s rule split,
    with ``o`` cut to match."""
    wo = p["wo"]
    if tp is None:
        return torch.einsum("bshk,hkd->bsd", o, wo)
    if parallel.split(tp, wo.shape[0], cfg.n_heads):
        if o.shape[2] == cfg.n_heads:
            o = parallel.enter(o, tp)[:, :, tp.slice_of(cfg.n_heads)]
    elif parallel.split(tp, wo.shape[1], cfg.head_dim):
        o = parallel.enter(_heads(o, cfg.n_heads, tp), tp)[..., tp.slice_of(cfg.head_dim)]
    else:
        return torch.einsum("bshk,hkd->bsd", _heads(o, cfg.n_heads, tp), wo)
    return parallel.row("bshk,hkd->bsd", o, wo, tp)


def _attend(p, cfg, q, k, v, positions, window, dtype, q_block, tp=None):
    """``attention_fwd`` after the projections: the mixing and the output
    projection, the result in ``dtype``."""
    if tp is not None:
        k, v = _kv_for_queries(cfg, q, k, v, tp)
    b, s, h, hd = q.shape
    if check_impl_name(cfg.kernel_impl, "flash_gqa") != "reference":
        with kernel_scope("flash_gqa", cfg.kernel_impl):
            o = flash_ops.flash_gqa(q, k, v, window=window, softcap=cfg.attn_softcap,
                                    impl=cfg.kernel_impl)
        return _out_proj(p, cfg, o.to(dtype), tp)

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
    return _out_proj(p, cfg, torch.cat(outs, dim=1), tp)


# ---------------------------------------------------------------------------
# Decode path (single new token against a KV cache)
# ---------------------------------------------------------------------------


def init_cache(cfg, batch, capacity, dtype, device, slots=None):
    """An empty ring buffer of ``capacity`` slots on ``device``; ``pos``
    holds each slot's absolute position (-1 = empty).  ``slots``: the
    slots this rank holds of a slot-split cache (``pos`` stays whole)."""
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    pos = torch.full((capacity,), -1, dtype=torch.int32, device=device)
    capacity = slots or capacity
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


def _write_owned(buf, slot, value, lo):
    """``buf[:, slot - lo] = value[:, 0]`` where this rank owns ``slot``
    (its slots are lo .. lo + n - 1), else an unchanged rewrite: no host
    sync on a tensor ``slot``."""
    n = buf.shape[1]
    if isinstance(slot, int):
        if lo <= slot < lo + n:
            buf[:, slot - lo] = value[:, 0]
        return
    local = (slot - lo).clamp(0, n - 1)
    owned = ((slot >= lo) & (slot < lo + n)).reshape((1, 1) + (1,) * (buf.dim() - 2))
    buf.index_copy_(1, local, torch.where(owned, value, buf.index_select(1, local)))


def _store_token(cache, name, slot, new, lo=None):
    """The new token's ``name`` ("k" or "v", (B,1,KV,hd)) written at slot
    ``slot``: quantised with its scale into an int8 cache.  ``lo``: the
    first slot of this rank's slice of a slot-split cache (the write
    then lands only on the owner, ``_write_owned``), None for a whole
    cache."""
    buf = cache[name]
    if name + "_scale" in cache:
        qv, sc = _quantize(new)
        parts = ((buf, qv), (cache[name + "_scale"], sc))
    else:
        parts = ((buf, new.to(buf.dtype)),)
    for dst, value in parts:
        if lo is None:
            _write_slot(dst, slot, value)
        else:
            _write_owned(dst, slot, value, lo)


def attention_decode(p, cfg, x, pos, cache, window, rope_base, tp=None):
    """Decode one token.

    x: (B,1,D) normed hidden; pos: the absolute position, a Python int or a
    0-d integer tensor (no host sync either way); cache: a ring buffer
    (capacity W for windowed layers, the sequence budget for full ones),
    updated in place at slot ``pos % capacity``; with ``tp``, this rank's
    slots of it where the model size divides the capacity (module
    docstring).  Returns (out (B,1,D), cache)."""
    b = x.shape[0]
    h, hd = cfg.n_heads, cfg.head_dim
    if not isinstance(pos, torch.Tensor):
        pos = int(pos)
    if isinstance(pos, torch.Tensor):
        positions = pos.to(device=x.device, dtype=torch.int32).reshape(1, 1).expand(b, 1)
    else:
        positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(p, cfg, x, positions, rope_base, tp)
    if tp is not None:  # every head: the cache holds them all
        q = _heads(q, h, tp)
        k_new, v_new = _heads(k_new, cfg.n_kv_heads, tp), _heads(v_new, cfg.n_kv_heads, tp)

    cap = cache["pos"].shape[0]
    split = tp is not None and parallel.split(tp, cache["k"].shape[1], cap)
    mine = tp.slice_of(cap) if split else slice(0, cap)
    slot = pos % cap if isinstance(pos, int) else (positions[:1, 0] % cap).long()
    if isinstance(slot, int):
        cache["pos"][slot] = pos
    else:
        cache["pos"].index_copy_(0, slot, positions[:1, 0])
    slot_pos = cache["pos"][mine]
    for name, new in (("k", k_new), ("v", v_new)):
        _store_token(cache, name, slot, new, mine.start if split else None)
    if "k_scale" in cache:  # this rank's slots dequantised in x's dtype, as repro does
        k = cache["k"].to(x.dtype) * cache["k_scale"][..., None].to(x.dtype)
        v = cache["v"].to(x.dtype) * cache["v_scale"][..., None].to(x.dtype)
    else:
        k, v = cache["k"], cache["v"]

    sc = _grouped_scores(q, k, cfg)  # (B,1,KV,G,slots)
    cur = positions[0, 0]
    valid = (slot_pos >= 0) & (slot_pos <= cur)
    if window is not None:
        valid &= (cur - slot_pos) < window
    sc = torch.where(valid[None, None, None, None, :], sc, NEG_INF)
    if split:  # this rank's slots: its max, sum and weighted V, combined
        top = sc.amax(-1, keepdim=True)
        e = torch.exp(sc - top)
        # exponentials cast to the storage dtype for the PV product, f32 sums
        o = torch.einsum("bqkgt,btkd->bqkgd", e.to(v.dtype).float(), v.float())
        o = parallel.combine_attention(top, e.sum(-1, keepdim=True), o, tp)
    else:
        w = torch.softmax(sc, dim=-1)
        # probabilities cast to the storage dtype for the PV product, f32 sums
        o = torch.einsum("bqkgt,btkd->bqkgd", w.to(v.dtype).float(), v.float())
    o = o.reshape(b, 1, h, hd).to(x.dtype)
    return _out_proj(p, cfg, o, tp), cache


def _owned_runs(s, take, cap, lo, hi):
    """(position, local slot, count) runs of the prompt's last ``take`` of
    ``s`` positions (canonical, 0 .. s - 1) whose slots ``p % cap`` fall in
    this rank's ``lo .. hi - 1``: the slots of consecutive positions wrap
    at most once, so at most two runs."""
    runs, p0 = [], s - take
    first = p0 % cap
    for pos, slot, n in ((p0, first, min(take, cap - first)),
                         (p0 + cap - first, 0, take - (cap - first))):
        a, z = max(slot, lo), min(slot + n, hi)
        if n > 0 and a < z:
            runs.append((pos + a - slot, a - lo, z - a))
    return runs


def pack_prefill_cache(cfg, k, v, positions, capacity, dtype, tp=None):
    """Full-sequence post-RoPE k/v (B,S,KV,hd) -> the ring-buffer cache that
    decode expects: slot(p) = p % capacity, keeping the last ``capacity``
    positions (all of them when capacity >= S).  With ``tp`` and a
    capacity the model size divides, this rank's slots only, from whole
    K/V heads and canonical positions."""
    b, s = k.shape[0], k.shape[1]
    cap = capacity or s  # >= s for full-attention layers, so decode does not
    #                      wrap onto the prompt
    take = min(cap, s)
    last_pos = positions[0, -take:].to(torch.int32)
    slots = (last_pos % cap).long()
    if tp is not None and cap % tp.size == 0:
        mine = tp.slice_of(cap)
        cache = init_cache(cfg, b, cap, dtype, k.device, slots=mine.stop - mine.start)
        for src, dst, n in _owned_runs(s, take, cap, mine.start, mine.stop):
            for name, x in (("k", k[:, src:src + n]), ("v", v[:, src:src + n])):
                if cfg.kv_quant:  # per (token, head) over whole heads: the whole cache's bits
                    cache[name][:, dst:dst + n], cache[name + "_scale"][:, dst:dst + n] = \
                        _quantize(x)
                else:
                    cache[name][:, dst:dst + n] = x
        cache["pos"].index_copy_(0, slots, last_pos)
        return cache
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
