"""Decoder stack (port of ``repro/models/transformer.py``): dense
(gemma/granite), MoE (olmoe, granite-moe), SSM (mamba2), hybrid (zamba2),
VLM (internvl2) and audio (musicgen) through one code path.

The layer schedule is ``cfg.pattern * n_rep + tail``.  Parameters are the
same nested dicts as ``repro``'s: ``params["pattern"]`` is a tuple (one
entry per pattern position) of blocks whose leaves carry a leading
``n_rep`` axis, so a tree carries across frameworks unchanged
(``repro_torch.weights``).  ``repro``'s ``lax.scan`` over the repetitions
is a loop over ``unbind(0)`` views here, and ``remat="block"`` is
``torch.utils.checkpoint`` (non-reentrant) around every sublayer: the
backward recomputes each block's forward, kernels included.

Sublayer kinds: ``attn`` (attention + gated MLP), ``moe`` (attention +
``models/moe.py``'s FFN, whose load-balance aux loss ``forward`` sums and
``lm_loss`` adds times ``AUX_LOSS_COEF``), ``ssm`` (``models/ssm.py``'s
Mamba2 mixer, no FFN) and ``shared_attn`` (Zamba2): ONE block,
``params["shared"]``, used at every repetition, while ``params["pattern"]``
holds an empty dict at its position, as ``repro``'s tree does; its KV
caches are per repetition, stacked like the rest.

Frontends: ``vision_stub`` projects ``batch["patch_embeds"]`` (B, n_patches,
d_vision) with ``vis_proj`` and prepends them to the token embeddings (the
loss reads the text region only); ``audio_codebooks`` sums the per-codebook
embeddings of ``batch["tokens"]`` (B, K, S) and has one head per codebook,
logits (B, S, K, V).  Otherwise the embedding is tied to the LM head
(logits = x @ embed.T) with the optional final-logit softcap.

Serving: ``init_caches`` builds ``repro``'s cache tree (``caches["pattern"]``
a tuple per pattern position of ring-buffer dicts whose leaves lead with
``n_rep``, ``caches["tail"]`` a tuple), so a cache crosses packages through
``weights.params_from_jax`` unchanged.  ``decode_step`` writes each
layer's new k/v (and each SSM layer's conv window and state) into
``unbind(0)`` views of the stacked caches, so the tree it returns is the
one it was given, updated in place.
``prefill_with_caches`` runs the prompt once and leaves the caches decode
continues from.  Both run without autograd.

Tensor-parallel serving: ``embed_inputs``, ``lm_logits``, ``forward``,
``decode_step`` and ``prefill_with_caches`` take ``tp``, a
``models/parallel.py`` ``TensorParallel``, with ``params`` and ``caches``
holding this rank's slices (``launch/sharding.py::rank_plan``,
``weights.cut``).  The embedding and the tied head are vocab-parallel
where the rules split the vocab (``lm_logits`` then returns this rank's
vocab slice of the logits), attention and the MLP as
``models/attention.py`` and ``models/layers.py::mlp`` say, and the
norms (K4) run on whole ``D`` rows on every rank: the residual stream is
replicated over the model group.  Every arch serves so: the MoE FFN with
its experts over the model group (``models/moe.py``), the Mamba2 mixer
on its Z / channel / head cuts (``models/ssm.py``), zamba2's shared
block through the dense path (``params["shared"]`` cut like any
attention block, a cache per invocation), the int8 cache on slots with
its scales (``models/attention.py``), the codebook tables and heads on
the vocab (``parallel.codebook_embed``; the logits (B, S, K, V/m)) and
the vision projection whole, on this data rank's patches.

Tensor-parallel training: every ``parallel`` op has its conjugate
backward, so ``lm_loss`` with ``tp`` is one rank's Megatron program of the
whole loss and its gradient (``launch/steps.py::make_train_step(tp=)``):
whole tensors enter split computation through ``parallel.enter`` (the
block inputs of the column-parallel projections, the gates and tokens of
a rank's experts, the SSM's slices, the tied head's input), the loss is
the vocab-parallel CE (``parallel.cross_entropy``) where the vocab is
split, ``remat="block"`` recomputes each block's forward with its
collectives, and every rank computes the MoE aux loss with the whole
router.  The gradient of a split leaf is this rank's slice of the whole
model's; of a replicated leaf, the whole one, bitwise equal on every
rank.

Sequence-parallel prefill (``repro``'s ``seqshard`` variant:
``cfg.seq_shard`` pins the residual stream to ``P("data", "model",
None)``): ``forward`` with ``cfg.seq_shard`` and a ``tp`` of m > 1 model
ranks runs one rank's program, ``params`` holding every layer leaf whole
and ``embed`` / ``heads`` vocab-cut (``launch/sharding.py::rank_plan(
seqshard=True)``, ``repro``'s ``_strip_model_axis``).  Model rank r holds
positions r S/m .. (r + 1) S/m - 1 of its data rank's rows (S counts the
vision frontend's patches): the embedding's vocab partial over every
position (the codebooks' summed over K, the patch region zero) is
reduce-scattered over the sequence (or, a whole ``embed``, looked up on
the rank's text positions), the patches among its positions are
projected there; the norms, projections, MLP and MoE run on its rows (the
capacity dispatches placing its slots in the whole model's order,
``models/moe.py``), attention gathers K/V over the sequence
(``models/attention.py::seq_attention_fwd``; zamba2's shared block
alike), the SSM mixer carries its conv halo and recurrent state across
ranks (``models/ssm.py::seq_ssm_forward``), the final norm runs on its
rows and the hidden state returned is its positions';
``last_position`` broadcasts the last one from rank m - 1 for the head.
It runs forward only (``repro`` has no sequence-parallel backward that
lowers: ROADMAP.md section 3, R7), on every arch and MoE impl.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import parallel
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    dense_init,
    embed_init,
    mlp,
    mlp_init,
    rmsnorm,
    rmsnorm_init,
    softcap,
)
from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import tree_flatten, tree_stack, tree_unflatten

AUX_LOSS_COEF = 0.01  # MoE load-balance coefficient (Switch / OLMoE default)


def _dtype(cfg):
    return getattr(torch, cfg.dtype)


def _norm(p, cfg, x):
    return rmsnorm(p, x, cfg.norm_eps, impl=cfg.kernel_impl)


# ---------------------------------------------------------------------------
# Long-context variant (the one documented carve-in for dense archs)
# ---------------------------------------------------------------------------


def apply_long_context(cfg):
    """For ``long_500k`` on window-mode archs: cap every attention window
    at ``cfg.long_context_window``.  SSM and hybrid archs
    (``long_context_mode="native"``) come back unchanged: their recurrence
    is already O(1) in context."""
    if cfg.long_context_mode != "window":
        return cfg
    w = cfg.long_context_window

    def capw(spec):
        if spec.kind in ("attn", "moe", "shared_attn"):
            return spec.replace(window=w if spec.window is None else min(spec.window, w))
        return spec

    return cfg.replace(pattern=tuple(capw(s) for s in cfg.pattern),
                       tail=tuple(capw(s) for s in cfg.tail))


# ---------------------------------------------------------------------------
# Block init / apply (one sublayer of the schedule)
# ---------------------------------------------------------------------------


def _block_init(gen, spec, cfg, dtype):
    dev = gen.device
    if spec.kind == "ssm":
        return {"ln1": rmsnorm_init(cfg.d_model, dtype, dev),
                "ssm": ssm_mod.ssm_init(gen, cfg, dtype)}
    p = {
        "ln1": rmsnorm_init(cfg.d_model, dtype, dev),
        "attn": attn_mod.attn_init(gen, cfg, dtype),
        "ln2": rmsnorm_init(cfg.d_model, dtype, dev),
    }
    if spec.kind == "moe":
        p["moe"] = moe_mod.moe_init(gen, cfg, dtype)
    else:  # attn / shared_attn
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.n_layers, dtype)
    return p


def _ffn(p, spec, cfg, x, tp=None, seq=None):
    """The sublayer's second half on the residual ``x``: (x, aux); ``seq``:
    the ``TensorParallel`` of a sequence-parallel prefill (``moe_ffn``'s)."""
    h = _norm(p["ln2"], cfg, x)
    if spec.kind == "moe":
        y, aux = moe_mod.moe_ffn(p["moe"], cfg, h, cfg.moe_impl, tp, seq)
        return x + y, aux
    return x + mlp(p["mlp"], h, tp=tp, d_ff=cfg.d_ff), None


def _block_fwd(p, spec, cfg, x, positions, tp=None):
    """Full-sequence (train/prefill) sublayer.  Returns (x, aux_loss f32)."""
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if spec.kind == "ssm":
        return x + ssm_mod.ssm_forward(p["ssm"], cfg, _norm(p["ln1"], cfg, x), tp), zero
    h = _norm(p["ln1"], cfg, x)
    x = x + attn_mod.attention_fwd(p["attn"], cfg, h, positions, spec.window,
                                   spec.rope_base, q_block=cfg.attn_q_block, tp=tp)
    x, aux = _ffn(p, spec, cfg, x, tp)
    return x, zero if aux is None else aux


def _block_decode(p, spec, cfg, x, pos, cache, tp=None):
    """Single-token sublayer; ``cache`` is updated in place."""
    if spec.kind == "ssm":
        y, cache = ssm_mod.ssm_decode(p["ssm"], cfg, _norm(p["ln1"], cfg, x), cache, tp)
        return x + y, cache
    h = _norm(p["ln1"], cfg, x)
    y, cache = attn_mod.attention_decode(p["attn"], cfg, h, pos, cache, spec.window,
                                         spec.rope_base, tp=tp)
    return _ffn(p, spec, cfg, x + y, tp)[0], cache


def _block_cache_init(spec, cfg, batch, seq_len, dtype, device):
    if spec.kind == "ssm":
        return ssm_mod.ssm_init_cache(cfg, batch, dtype, device)
    cap = seq_len if spec.window is None else min(spec.window, seq_len)
    return attn_mod.init_cache(cfg, batch, cap, dtype, device)


def _block_prefill(p, spec, cfg, x, positions, capacity, tp=None):
    """Sublayer forward that also builds the decode cache it leaves behind.

    ``capacity``: total sequence budget (prompt + planned decode steps);
    full-attention layers allocate it outright, windowed layers
    min(window, capacity).  The projections are computed once and feed
    both the cache and the attention (``repro`` projects twice; the values
    are the same).  An SSM sublayer leaves its conv window and state."""
    if spec.kind == "ssm":
        y, cache = ssm_mod.ssm_forward_with_cache(p["ssm"], cfg, _norm(p["ln1"], cfg, x), tp)
        return x + y, cache
    h = _norm(p["ln1"], cfg, x)
    q, k, v = attn_mod._project_qkv(p["attn"], cfg, h, positions, spec.rope_base, tp)
    cap = capacity if spec.window is None else min(spec.window, capacity)
    kv = cfg.n_kv_heads  # the cache holds every KV head
    cache = attn_mod.pack_prefill_cache(cfg, attn_mod._heads(k, kv, tp),
                                        attn_mod._heads(v, kv, tp), positions, cap,
                                        _dtype(cfg), tp)
    x = x + attn_mod._attend(p["attn"], cfg, q, k, v, positions, spec.window, h.dtype,
                             cfg.attn_q_block, tp)
    return _ffn(p, spec, cfg, x, tp)[0], cache


def _unstack(tree, n):
    """A tree with a leading n-long axis on every leaf -> n trees of views
    (an empty tree, a ``shared_attn`` position, -> n empty trees)."""
    leaves, treedef = tree_flatten(tree)
    parts = [x.unbind(0) for x in leaves]
    return [tree_unflatten(treedef, [p[r] for p in parts]) for r in range(n)]


def _layers(tree, n_rep):
    """``params`` or ``caches`` per layer, in layer order: views into the
    pattern's stacked trees (one per pattern position, leaves leading with
    ``n_rep``), repetition by repetition, then the tail's trees."""
    stacked = tree.get("pattern", ())
    reps = [_unstack(t, n_rep) for t in stacked]  # [position][rep]
    return ([reps[j][r] for r in range(n_rep) for j in range(len(stacked))]
            + list(tree.get("tail", ())))


def _schedule(params, cfg):
    """[(block params, spec)] in layer order; ``shared_attn`` sublayers get
    ``params["shared"]``."""
    return [(params.get("shared") if s.kind == "shared_attn" else p, s)
            for p, s in zip(_layers(params, cfg.n_rep), cfg.layers)]


# ---------------------------------------------------------------------------
# Whole-model init
# ---------------------------------------------------------------------------


def init_params(gen, cfg, device="cuda"):
    """Random init drawn from ``gen`` on its device, returned on ``device``
    (``repro``'s init bits cannot be reproduced in torch: parity tests carry
    ``repro``'s tree across instead)."""
    dev = resolve_device(device)
    dtype = _dtype(cfg)
    params: dict[str, Any] = {}
    if cfg.frontend == "audio_codebooks":
        params["embed"] = embed_init(gen, (cfg.n_codebooks, cfg.vocab_size, cfg.d_model), dtype)
        params["heads"] = dense_init(gen, (cfg.n_codebooks, cfg.d_model, cfg.vocab_size),
                                     cfg.d_model, dtype)
    else:
        params["embed"] = embed_init(gen, (cfg.vocab_size, cfg.d_model), dtype)
    if cfg.frontend == "vision_stub":
        params["vis_proj"] = dense_init(gen, (cfg.d_vision, cfg.d_model), cfg.d_vision, dtype)
    shared = next((s for s in cfg.layers if s.kind == "shared_attn"), None)
    if shared is not None:
        params["shared"] = _block_init(gen, shared, cfg, dtype)
    if cfg.pattern and cfg.n_rep:
        reps = [[{} if s.kind == "shared_attn" else _block_init(gen, s, cfg, dtype)
                 for s in cfg.pattern] for _ in range(cfg.n_rep)]
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


def serves_tensor_parallel(cfg) -> bool:
    """Whether ``cfg`` takes a ``tp``: every decoder stack (the ten archs)."""
    return bool(cfg.layers)


def check_seq_shard(cfg) -> None:
    """Raise unless ``cfg``'s forward can run sequence-parallel: every
    decoder stack (the ten archs, each MoE impl)."""
    if not serves_tensor_parallel(cfg):
        raise NotImplementedError(
            f"a sequence-parallel (seq_shard) forward of {cfg.name}: it has no decoder stack")


def seq_parallel(cfg, tp) -> bool:
    """Whether ``forward`` runs the sequence-parallel program (the module
    docstring): ``cfg.seq_shard`` under a ``tp`` of more than one model
    rank; raises for a config it does not take."""
    if not cfg.seq_shard or tp is None:
        return False
    check_seq_shard(cfg)
    return tp.size > 1


def _seq_positions(rows: slice, b: int, device) -> torch.Tensor:
    """(B, S/m) int32: the global positions of this rank's rows."""
    return torch.arange(rows.start, rows.stop, dtype=torch.int32, device=device)[None].expand(
        b, -1)


def _frontend_rows(rows: slice, n_patches: int):
    """(the patches, the text tokens) at the positions ``rows`` of a
    sequence whose first ``n_patches`` positions are patches: two slices,
    either possibly empty."""
    return (slice(min(rows.start, n_patches), min(rows.stop, n_patches)),
            slice(max(rows.start, n_patches) - n_patches, max(rows.stop, n_patches) - n_patches))


def _seq_embed(params, cfg, batch, tp):
    """(x (B, S/m, D), positions (B, S/m)) of this rank's positions: the
    vocab partial over every position (the codebooks' summed over K, the
    patch region zero) reduce-scattered over the sequence, or a whole
    ``embed`` looked up on its text positions; the vision projection on
    the patches among its positions."""
    toks, emb = batch["tokens"], params["embed"]
    b, s_text = toks.shape[0], toks.shape[-1]
    n_patch = cfg.n_patches if cfg.frontend == "vision_stub" else 0
    rows = parallel.seq_rows(tp, n_patch + s_text)
    patch, text = _frontend_rows(rows, n_patch)
    scale = torch.tensor(np.sqrt(cfg.d_model), dtype=emb.dtype, device=emb.device)
    codebooks = cfg.frontend == "audio_codebooks"
    if parallel.split(tp, emb.shape[-2], cfg.vocab_size):
        if codebooks:
            part = 0
            for k in range(cfg.n_codebooks):
                part = part + parallel.vocab_partial(toks[:, k], emb[k], tp)
        else:
            part = parallel.vocab_partial(toks, emb, tp)
        if n_patch:
            part = torch.cat([part.new_zeros((b, n_patch, cfg.d_model)), part], dim=1)
        x = parallel.seq_scatter(part, tp)[:, patch.stop - patch.start:]
    elif codebooks:
        x = 0  # repro's sum(...) order
        for k in range(cfg.n_codebooks):
            x = x + F.embedding(toks[:, k, text], emb[k])
    else:
        x = F.embedding(toks[:, text], emb)
    x = x * scale
    if patch.stop > patch.start:
        x = torch.cat([batch["patch_embeds"][:, patch].to(emb.dtype) @ params["vis_proj"], x],
                      dim=1)
    return x, _seq_positions(rows, b, toks.device)


def _seq_forward(params, cfg, batch, tp):
    """``forward``'s sequence-parallel program (the module docstring):
    (this rank's positions of the normed hidden state, the MoE aux loss of
    its rows)."""
    if torch.is_grad_enabled():
        raise NotImplementedError(
            "the sequence-parallel forward runs under no_grad: repro has no sequence-"
            "parallel backward that lowers (ROADMAP.md section 3, R7)")
    x, positions = _seq_embed(params, cfg, batch, tp)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for p, spec in _schedule(params, cfg):
        h = _norm(p["ln1"], cfg, x)
        if spec.kind == "ssm":
            x = x + ssm_mod.seq_ssm_forward(p["ssm"], cfg, h, tp)
            continue
        x = x + attn_mod.seq_attention_fwd(p["attn"], cfg, h, positions, spec.window,
                                           spec.rope_base, tp)
        x, aux = _ffn(p, spec, cfg, x, seq=tp)
        if aux is not None:
            aux_total = aux_total + aux
    return _norm(params["final_norm"], cfg, x), aux_total


def last_position(x, cfg, tp=None):
    """The last position of ``forward``'s hidden state, (B, 1, D): on every
    rank of a sequence-parallel forward, model rank m - 1's."""
    if seq_parallel(cfg, tp):
        return parallel.seq_last(x, tp)
    return x[:, -1:, :]


def embed_inputs(params, cfg, batch, tp=None):
    """Returns (x (B,S,D), positions (B,S)).  ``batch["tokens"]`` is (B, S),
    or (B, K, S) for ``audio_codebooks``; ``vision_stub`` also takes
    ``batch["patch_embeds"]`` (B, n_patches, d_vision), n_patches >= 0.
    With ``tp``, ``params["embed"]`` may hold a vocab slice."""
    toks = batch["tokens"]
    emb = params["embed"]
    scale = torch.tensor(np.sqrt(cfg.d_model), dtype=emb.dtype, device=emb.device)
    if tp is not None and cfg.frontend == "audio_codebooks":
        x = parallel.codebook_embed(toks, emb, tp, cfg.vocab_size) * scale
    elif tp is not None:
        x = parallel.vocab_embed(toks, emb, tp, cfg.vocab_size) * scale
    elif cfg.frontend == "audio_codebooks":
        x = 0  # repro's sum(...) order
        for k in range(cfg.n_codebooks):
            x = x + F.embedding(toks[:, k], emb[k])
        x = x * scale
    else:
        x = F.embedding(toks, emb) * scale
    if cfg.frontend == "vision_stub":
        patches = batch["patch_embeds"].to(emb.dtype) @ params["vis_proj"]
        x = torch.cat([patches, x], dim=1)
    b, s = x.shape[0], x.shape[1]
    pos = torch.arange(s, dtype=torch.int32, device=toks.device)[None].expand(b, s)
    return x, pos


def lm_logits(params, cfg, x, tp=None):
    """Tied LM head with the optional final-logit softcap (f32); the audio
    frontend's per-codebook heads give (B, S, K, V).  With ``tp`` and a
    vocab-split ``embed`` or ``heads``: this rank's vocab slice of the
    logits ((B, S, K, V/m) for the codebook heads), whose columns read ``x``
    through ``parallel.enter``."""
    head = params["heads"] if cfg.frontend == "audio_codebooks" else params["embed"]
    if tp is not None and parallel.split(tp, head.shape[-1 if head.dim() == 3 else 0],
                                         cfg.vocab_size):
        x = parallel.enter(x, tp)
    if cfg.frontend == "audio_codebooks":
        return torch.einsum("bsd,kdv->bskv", x, head)
    logits = torch.einsum("bsd,vd->bsv", x, head)
    if cfg.final_softcap is not None:
        logits = softcap(logits.float(), cfg.final_softcap)
    return logits


def forward(params, cfg, batch, tp=None):
    """Returns (hidden (B,S,D), aux_loss scalar f32: the MoE sublayers'
    load-balance losses summed in layer order, zero without them).  With
    ``tp``, this rank's slices of ``params``; the hidden state is whole on
    every rank.  Under ``remat="block"`` the backward recomputes each
    block's forward, its collectives included.  With ``cfg.seq_shard``
    and ``tp``, the sequence-parallel program: this rank's positions of
    the hidden state (B, S/m, D) (the module docstring)."""
    if seq_parallel(cfg, tp):
        return _seq_forward(params, cfg, batch, tp)
    x, positions = embed_inputs(params, cfg, batch, tp)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for p, spec in _schedule(params, cfg):
        if cfg.remat == "block":
            x, a = checkpoint(_block_fwd, p, spec, cfg, x, positions, tp,
                              use_reentrant=False)
        else:
            x, a = _block_fwd(p, spec, cfg, x, positions, tp)
        aux_total = aux_total + a
    return _norm(params["final_norm"], cfg, x), aux_total


def cross_entropy(logits, labels, mask=None):
    """Mean CE in f32.  logits (..., V), labels (...) integer."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def lm_loss(params, cfg, batch, tp=None):
    """Next-token CE (+ the MoE aux loss).  ``batch["labels"]`` is aligned
    with the text positions: (B, S), or (B, K, S) for the codebooks; the
    vision frontend's patches carry no labels.  With ``tp`` and a
    vocab-split head, the vocab-parallel CE (``parallel.cross_entropy``) on
    this rank's slice of the logits; the loss is whole on every rank."""
    hidden, aux = forward(params, cfg, batch, tp)
    if cfg.frontend == "vision_stub":
        hidden = hidden[:, cfg.n_patches:, :]  # the text region only
    labels = batch["labels"]
    if cfg.frontend == "audio_codebooks":
        labels = labels.movedim(1, 2)  # (B, S, K), as the logits
    logits = lm_logits(params, cfg, hidden, tp)
    if tp is not None and parallel.split(tp, logits.shape[-1], cfg.vocab_size):
        ce = parallel.cross_entropy(logits, labels, tp)
    else:
        ce = cross_entropy(logits, labels)
    return ce + AUX_LOSS_COEF * aux


# ---------------------------------------------------------------------------
# Decode (single new token against caches) and the prefill handoff
# ---------------------------------------------------------------------------


def init_caches(cfg, batch, seq_len, device="cuda"):
    """Empty decode caches for ``batch`` sequences of up to ``seq_len``
    tokens, on ``device``."""
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
def decode_step(params, cfg, batch, pos, caches, tp=None):
    """One token for every sequence in the batch.

    ``batch["tokens"]``: (B, 1), or (B, K, 1) for the codebooks (the vision
    frontend's ``patch_embeds`` hold 0 patches here); ``pos``: the absolute
    position (a Python int or a 0-d tensor).  Returns (logits (B,1,V), or
    (B,1,K,V), caches), the caches updated in place.  With ``tp``: this
    rank's slices of ``params`` and ``caches``, and its vocab slice of
    the logits."""
    x, _ = embed_inputs(params, cfg, batch, tp)  # (B,1,D)
    for (p, spec), cache in zip(_schedule(params, cfg), _layers(caches, cfg.n_rep)):
        x, _ = _block_decode(p, spec, cfg, x, pos, cache, tp)
    x = _norm(params["final_norm"], cfg, x)
    return lm_logits(params, cfg, x, tp), caches


@torch.no_grad()
def prefill_with_caches(params, cfg, batch, capacity=None, tp=None):
    """Full prompt forward returning (last-token logits, decode caches).

    ``capacity``: total sequence budget (prompt + decode steps; defaults to
    prompt_len + 64).  The caches have ``init_caches(cfg, B, capacity)``'s
    structure, so ``decode_step(params, cfg, next_tok, S, caches)``
    continues the sequence.  With ``tp``: this rank's slices of the
    caches (``decode_step``'s ``tp`` layout) and its vocab slice of the
    logits."""
    if seq_parallel(cfg, tp):
        raise NotImplementedError(
            "prefill_with_caches under seq_shard: the sequence-parallel prefill leaves no "
            "decode caches (launch/steps.py::make_prefill_step runs it; decode serves the "
            "tensor-parallel layout, as repro's seqshard decode does)")
    x, positions = embed_inputs(params, cfg, batch, tp)
    seq_len = capacity or (x.shape[1] + 64)
    made = []
    for p, spec in _schedule(params, cfg):
        x, c = _block_prefill(p, spec, cfg, x, positions, seq_len, tp)
        made.append(c)
    caches: dict[str, Any] = {}
    npat = len(cfg.pattern) * cfg.n_rep
    if cfg.pattern and cfg.n_rep:
        caches["pattern"] = tuple(tree_stack(made[j:npat:len(cfg.pattern)])
                                  for j in range(len(cfg.pattern)))
    if cfg.tail:
        caches["tail"] = tuple(made[npat:])
    x = _norm(params["final_norm"], cfg, x)
    return lm_logits(params, cfg, x[:, -1:, :], tp), caches
