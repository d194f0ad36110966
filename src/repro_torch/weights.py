"""Carry parameter trees between ``repro`` (JAX) and the port.

Both packages use the same nested-dict layout (``repro_torch.models.cnn``
keeps JAX's HWIO conv weights), so a tree moves across as numpy leaves:
``params_from_jax(jax.tree.map(np.asarray, params), device)`` here, and
``params_to_numpy`` back.  ``jax.random`` init bits cannot be reproduced
in torch, so parity tests carry ``repro``'s initialization across.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import tree_map


def params_from_jax(tree, device="cuda"):
    """Tree of numpy arrays (same structure as ``repro``'s) -> tensors."""
    dev = resolve_device(device)
    return tree_map(lambda x: torch.from_numpy(np.array(x)).to(dev), tree)


def params_to_numpy(tree):
    return tree_map(lambda x: x.detach().cpu().numpy(), tree)
