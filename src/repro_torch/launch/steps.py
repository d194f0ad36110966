"""Serving steps (port of the single-device half of
``repro/launch/steps.py``).

  make_prefill_step  full forward, last-position logits
  make_serve_step    one new token against the KV caches; greedy sampling
                     (``argmax``: ties go to the first index, as in JAX)

``repro``'s steps carry a leading pod axis and ``vmap`` over it; that axis
belongs to the multi-device mesh (ROADMAP.md queue 1, item 16), so these
take the unbatched tree of one pod.  The pFedSOP train step and the
input-spec builders come with that item too.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models import transformer as tf


def resolve_cfg(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """The config a shape runs: ``long_500k`` caps every attention window
    (``apply_long_context``), which is not ported yet."""
    if shape.name == "long_500k":
        raise NotImplementedError(
            "long_500k needs apply_long_context, which comes with the non-dense "
            "archs (ROADMAP.md queue 1, item 14)")
    return cfg


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
        """-> (next tokens (B, 1) int32, caches updated in place)."""
        logits, caches = tf.decode_step(params, cfg, batch, pos, caches)
        return logits.argmax(-1).to(torch.int32), caches

    return serve_step
