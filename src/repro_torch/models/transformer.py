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
archs, and the decode/prefill-with-cache entry points, raise
``NotImplementedError`` until their slices are ported (ROADMAP.md queue 1,
items 14 and 15).
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


def _unported(name):
    def fn(*args, **kwargs):
        raise NotImplementedError(
            f"transformer.{name}: the decode and KV-cache path comes with the "
            "serving slice (ROADMAP.md queue 1, item 15)")
    fn.__name__ = name
    return fn


init_caches = _unported("init_caches")
decode_step = _unported("decode_step")
prefill_with_caches = _unported("prefill_with_caches")
