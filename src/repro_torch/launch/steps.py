"""Serving steps (port of the single-device half of
``repro/launch/steps.py``).

  make_prefill_step  full forward, last-position logits
  make_serve_step    one new token against the KV caches; greedy sampling
                     (``argmax``: ties go to the first index, as in JAX)

and the batch layouts they take, per modality frontend (``repro``'s
``_token_batch`` / ``_decode_batch``), as ``{name: (shape, dtype)}``
specs.

``repro``'s steps carry a leading pod axis and ``vmap`` over it; that axis
belongs to the multi-device mesh (ROADMAP.md queue 1, item 16), so these
take the unbatched tree of one pod.  The pFedSOP train step and
``input_specs`` (the stacked per-client specs) come with that item too.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models import transformer as tf
from repro_torch.models.transformer import apply_long_context


def resolve_cfg(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """The config a shape runs: ``long_500k`` caps every attention window
    (``apply_long_context``)."""
    if shape.name == "long_500k":
        return apply_long_context(cfg)
    return cfg


def token_batch(cfg: ModelConfig, b: int, s: int) -> dict:
    """A training / prefill batch of ``s`` positions: tokens and labels
    (B, S), or (B, K, S) for the codebooks; the vision frontend's
    ``n_patches`` of the ``s`` positions are patch embeddings."""
    i32 = torch.int32
    if cfg.frontend == "audio_codebooks":
        return {"tokens": ((b, cfg.n_codebooks, s), i32),
                "labels": ((b, cfg.n_codebooks, s), i32)}
    if cfg.frontend == "vision_stub":
        s_text = s - cfg.n_patches
        return {"tokens": ((b, s_text), i32), "labels": ((b, s_text), i32),
                "patch_embeds": ((b, cfg.n_patches, cfg.d_vision), torch.float32)}
    return {"tokens": ((b, s), i32), "labels": ((b, s), i32)}


def decode_batch(cfg: ModelConfig, b: int) -> dict:
    """One decode step's batch: a token per sequence (per codebook), and
    for the vision frontend no patches."""
    i32 = torch.int32
    if cfg.frontend == "audio_codebooks":
        return {"tokens": ((b, cfg.n_codebooks, 1), i32)}
    if cfg.frontend == "vision_stub":
        return {"tokens": ((b, 1), i32),
                "patch_embeds": ((b, 0, cfg.d_vision), torch.float32)}
    return {"tokens": ((b, 1), i32)}


def next_tokens(cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """``make_serve_step``'s tokens (B, 1), or (B, 1, K) for the codebooks,
    as the next decode batch's ``tokens`` (B, 1) / (B, K, 1)."""
    return tokens.transpose(1, 2) if cfg.frontend == "audio_codebooks" else tokens


def make_prefill_step(cfg: ModelConfig, shape: InputShape):
    cfg = resolve_cfg(cfg, shape)

    @torch.no_grad()
    def prefill_step(params, batch):
        hidden, _ = tf.forward(params, cfg, batch)
        return tf.lm_logits(params, cfg, hidden[:, -1:, :])

    return prefill_step


def make_serve_step(cfg: ModelConfig, shape: InputShape):
    cfg = resolve_cfg(cfg, shape)

    def serve_step(params, batch, pos, caches):
        """-> (next tokens (B, 1), or (B, 1, K) for the codebooks, int32;
        caches updated in place)."""
        logits, caches = tf.decode_step(params, cfg, batch, pos, caches)
        return logits.argmax(-1).to(torch.int32), caches

    return serve_step
