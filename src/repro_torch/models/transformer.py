"""Decoder stack, dense text path (port of ``repro/models/transformer.py``).

The layer schedule is ``cfg.pattern * n_rep + tail``.  Parameters are the
same nested dicts as ``repro``'s: ``params["pattern"]`` is a tuple (one
entry per pattern position) of blocks whose leaves carry a leading
``n_rep`` axis, so a tree carries across frameworks unchanged
(``repro_torch.weights``).  ``repro``'s ``lax.scan`` over the repetitions
is a loop over ``unbind(0)`` views here, and ``remat="block"`` is
``torch.utils.checkpoint`` (non-reentrant) around every sublayer: the
backward recomputes each block's forward, kernels included.

Embedding is tied to the LM head (logits = x @ embed.T) with the optional
final-logit softcap.  MoE, SSM, shared-attention and modality-frontend
archs raise ``NotImplementedError`` until their slice is ported
(ROADMAP.md queue 1, item 14).

Serving: ``init_caches`` builds ``repro``'s cache tree (``caches["pattern"]``
a tuple per pattern position of ring-buffer dicts whose leaves lead with
``n_rep``, ``caches["tail"]`` a tuple), so a cache crosses packages through
``weights.params_from_jax`` unchanged.  ``decode_step`` writes each
layer's new k/v into ``unbind(0)`` views of the stacked caches, so the
tree it returns is the one it was given, updated in place.
``prefill_with_caches`` runs the prompt once and leaves the caches decode
continues from.  Both run without autograd.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import embed_init, mlp, mlp_init, rmsnorm, rmsnorm_init, softcap
from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import tree_flatten, tree_stack, tree_unflatten

AUX_LOSS_COEF = 0.01  # MoE load-balance coefficient (repro's; zero aux here)


def _dtype(cfg):
    return getattr(torch, cfg.dtype)


def _check_dense(cfg):
    kinds = {s.kind for s in cfg.layers}
    if cfg.frontend != "none" or kinds - {"attn"}:
        raise NotImplementedError(
            f"{cfg.name}: sublayer kinds {sorted(kinds)}, frontend {cfg.frontend!r}; "
            "only the dense text path ('attn' sublayers, no frontend) is ported — "
            "MoE, SSM, hybrid and frontends are ROADMAP.md queue 1, item 14")


def _norm(p, cfg, x):
    return rmsnorm(p, x, cfg.norm_eps, impl=cfg.kernel_impl)


# ---------------------------------------------------------------------------
# Block init / apply
# ---------------------------------------------------------------------------


def _block_init(gen, spec, cfg, dtype):
    return {
        "ln1": rmsnorm_init(cfg.d_model, dtype, gen.device),
        "attn": attn_mod.attn_init(gen, cfg, dtype),
        "ln2": rmsnorm_init(cfg.d_model, dtype, gen.device),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.n_layers, dtype),
    }


def _block_fwd(p, spec, cfg, x, positions):
    """Full-sequence (train/prefill) sublayer."""
    h = _norm(p["ln1"], cfg, x)
    x = x + attn_mod.attention_fwd(p["attn"], cfg, h, positions, spec.window,
                                   spec.rope_base, q_block=cfg.attn_q_block)
    return x + mlp(p["mlp"], _norm(p["ln2"], cfg, x))


def _block_decode(p, spec, cfg, x, pos, cache):
    """Single-token sublayer; ``cache`` is updated in place."""
    h = _norm(p["ln1"], cfg, x)
    y, cache = attn_mod.attention_decode(p["attn"], cfg, h, pos, cache, spec.window,
                                         spec.rope_base)
    x = x + y
    return x + mlp(p["mlp"], _norm(p["ln2"], cfg, x)), cache


def _block_cache_init(spec, cfg, batch, seq_len, dtype, device):
    cap = seq_len if spec.window is None else min(spec.window, seq_len)
    return attn_mod.init_cache(cfg, batch, cap, dtype, device)


def _block_prefill(p, spec, cfg, x, positions, capacity):
    """Sublayer forward that also builds the decode cache it leaves behind.

    ``capacity``: total sequence budget (prompt + planned decode steps);
    full-attention layers allocate it outright, windowed layers
    min(window, capacity).  The projections are computed once and feed
    both the cache and the attention (``repro`` projects twice; the values
    are the same)."""
    h = _norm(p["ln1"], cfg, x)
    q, k, v = attn_mod._project_qkv(p["attn"], cfg, h, positions, spec.rope_base)
    cap = capacity if spec.window is None else min(spec.window, capacity)
    cache = attn_mod.pack_prefill_cache(cfg, k, v, positions, cap, _dtype(cfg))
    x = x + attn_mod._attend(p["attn"], cfg, q, k, v, positions, spec.window, h.dtype,
                             cfg.attn_q_block)
    return x + mlp(p["mlp"], _norm(p["ln2"], cfg, x)), cache


def _unstack(tree):
    """A tree with a leading n_rep axis on every leaf -> n_rep trees of views."""
    leaves, treedef = tree_flatten(tree)
    parts = [x.unbind(0) for x in leaves]
    return [tree_unflatten(treedef, [p[r] for p in parts]) for r in range(len(parts[0]))]


# ---------------------------------------------------------------------------
# Whole-model init
# ---------------------------------------------------------------------------


def init_params(gen, cfg, device="cuda"):
    """Random init drawn from ``gen`` on its device, returned on ``device``
    (``repro``'s init bits cannot be reproduced in torch: parity tests carry
    ``repro``'s tree across instead)."""
    _check_dense(cfg)
    dev = resolve_device(device)
    dtype = _dtype(cfg)
    params: dict[str, Any] = {"embed": embed_init(gen, (cfg.vocab_size, cfg.d_model), dtype)}
    if cfg.pattern and cfg.n_rep:
        reps = [[_block_init(gen, s, cfg, dtype) for s in cfg.pattern]
                for _ in range(cfg.n_rep)]
        params["pattern"] = tuple(tree_stack([rep[j] for rep in reps])
                                  for j in range(len(cfg.pattern)))
        del reps
    if cfg.tail:
        params["tail"] = tuple(_block_init(gen, s, cfg, dtype) for s in cfg.tail)
    params["final_norm"] = rmsnorm_init(cfg.d_model, dtype, gen.device)
    return {k: _to(v, dev) for k, v in params.items()}


def _to(tree, dev):
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [x.to(dev) for x in leaves])


# ---------------------------------------------------------------------------
# Embedding, head, forward, loss
# ---------------------------------------------------------------------------


def embed_inputs(params, cfg, batch):
    """Returns (x (B,S,D), positions (B,S))."""
    _check_dense(cfg)
    toks = batch["tokens"]
    emb = params["embed"]
    scale = torch.tensor(np.sqrt(cfg.d_model), dtype=emb.dtype, device=emb.device)
    x = F.embedding(toks, emb) * scale
    b, s = toks.shape
    pos = torch.arange(s, dtype=torch.int32, device=toks.device)[None].expand(b, s)
    return x, pos


def lm_logits(params, cfg, x):
    """Tied LM head with the optional final-logit softcap (f32)."""
    logits = torch.einsum("bsd,vd->bsv", x, params["embed"])
    if cfg.final_softcap is not None:
        logits = softcap(logits.float(), cfg.final_softcap)
    return logits


def forward(params, cfg, batch):
    """Returns (hidden (B,S,D), aux_loss scalar f32 — zero on the dense path)."""
    _check_dense(cfg)
    x, positions = embed_inputs(params, cfg, batch)

    def apply_block(p, spec, x):
        if cfg.remat == "block":
            return checkpoint(_block_fwd, p, spec, cfg, x, positions, use_reentrant=False)
        return _block_fwd(p, spec, cfg, x, positions)

    if cfg.pattern and cfg.n_rep:
        reps = [_unstack(rp) for rp in params["pattern"]]  # [position][rep]
        for r in range(cfg.n_rep):
            for j, spec in enumerate(cfg.pattern):
                x = apply_block(reps[j][r], spec, x)
    for j, spec in enumerate(cfg.tail):
        x = apply_block(params["tail"][j], spec, x)
    x = _norm(params["final_norm"], cfg, x)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def cross_entropy(logits, labels, mask=None):
    """Mean CE in f32.  logits (..., V), labels (...) integer."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def lm_loss(params, cfg, batch):
    """Next-token CE.  batch["labels"] aligned with positions."""
    hidden, aux = forward(params, cfg, batch)
    return cross_entropy(lm_logits(params, cfg, hidden), batch["labels"]) + AUX_LOSS_COEF * aux


# ---------------------------------------------------------------------------
# Decode (single new token against caches) and the prefill handoff
# ---------------------------------------------------------------------------


def init_caches(cfg, batch, seq_len, device="cuda"):
    """Empty decode caches for ``batch`` sequences of up to ``seq_len``
    tokens, on ``device``."""
    _check_dense(cfg)
    dev = resolve_device(device)
    dtype = _dtype(cfg)
    caches: dict[str, Any] = {}
    if cfg.pattern and cfg.n_rep:
        caches["pattern"] = tuple(
            {k: x.expand((cfg.n_rep,) + tuple(x.shape)).clone() for k, x in
             _block_cache_init(s, cfg, batch, seq_len, dtype, dev).items()}
            for s in cfg.pattern)
    if cfg.tail:
        caches["tail"] = tuple(_block_cache_init(s, cfg, batch, seq_len, dtype, dev)
                               for s in cfg.tail)
    return caches


@torch.no_grad()
def decode_step(params, cfg, batch, pos, caches):
    """One token for every sequence in the batch.

    ``batch["tokens"]``: (B, 1); ``pos``: the absolute position (a Python
    int or a 0-d tensor).  Returns (logits (B,1,V), caches), the caches
    updated in place."""
    _check_dense(cfg)
    x, _ = embed_inputs(params, cfg, batch)  # (B,1,D)
    if cfg.pattern and cfg.n_rep:
        reps = [_unstack(rp) for rp in params["pattern"]]  # [position][rep]
        creps = [_unstack(c) for c in caches["pattern"]]  # views into the stacks
        for r in range(cfg.n_rep):
            for j, spec in enumerate(cfg.pattern):
                x, _ = _block_decode(reps[j][r], spec, cfg, x, pos, creps[j][r])
    for j, spec in enumerate(cfg.tail):
        x, _ = _block_decode(params["tail"][j], spec, cfg, x, pos, caches["tail"][j])
    x = _norm(params["final_norm"], cfg, x)
    return lm_logits(params, cfg, x), caches


@torch.no_grad()
def prefill_with_caches(params, cfg, batch, capacity=None):
    """Full prompt forward returning (last-token logits, decode caches).

    ``capacity``: total sequence budget (prompt + decode steps; defaults to
    prompt_len + 64).  The caches have ``init_caches(cfg, B, capacity)``'s
    structure, so ``decode_step(params, cfg, next_tok, S, caches)``
    continues the sequence."""
    _check_dense(cfg)
    x, positions = embed_inputs(params, cfg, batch)
    seq_len = capacity or (x.shape[1] + 64)
    caches: dict[str, Any] = {}
    if cfg.pattern and cfg.n_rep:
        reps = [_unstack(rp) for rp in params["pattern"]]
        made = [[None] * cfg.n_rep for _ in cfg.pattern]
        for r in range(cfg.n_rep):
            for j, spec in enumerate(cfg.pattern):
                x, made[j][r] = _block_prefill(reps[j][r], spec, cfg, x, positions, seq_len)
        caches["pattern"] = tuple(tree_stack(m) for m in made)
    if cfg.tail:
        tail = []
        for j, spec in enumerate(cfg.tail):
            x, c = _block_prefill(params["tail"][j], spec, cfg, x, positions, seq_len)
            tail.append(c)
        caches["tail"] = tuple(tail)
    x = _norm(params["final_norm"], cfg, x)
    return lm_logits(params, cfg, x[:, -1:, :]), caches
