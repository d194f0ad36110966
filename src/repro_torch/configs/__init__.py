"""Model configs: stdlib-only copies of ``repro.configs`` (``base`` byte
for byte; each arch module differs only in its import line).

``get_config("gemma3-1b")`` returns the full config and
``get_config("gemma3-1b", reduced=True)`` the CPU-smoke variant, as in
``repro``: the dense, MoE, SSM, hybrid and modality-frontend archs alike.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    DECODE_32K,
    INPUT_SHAPES,
    LONG_500K,
    PREFILL_32K,
    TRAIN_4K,
    InputShape,
    LayerSpec,
    ModelConfig,
)

_MODULES = {
    "gemma3-1b": "repro_torch.configs.gemma3_1b",
    "musicgen-large": "repro_torch.configs.musicgen_large",
    "granite-3-2b": "repro_torch.configs.granite_3_2b",
    "granite-3-8b": "repro_torch.configs.granite_3_8b",
    "mamba2-2.7b": "repro_torch.configs.mamba2_2_7b",
    "zamba2-2.7b": "repro_torch.configs.zamba2_2_7b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "gemma2-9b": "repro_torch.configs.gemma2_9b",
    "granite-moe-1b-a400m": "repro_torch.configs.granite_moe_1b_a400m",
    "internvl2-2b": "repro_torch.configs.internvl2_2b",
    "resnet-cifar": "repro_torch.configs.resnet_cifar",
}

ARCH_NAMES = tuple(n for n in _MODULES if n != "resnet-cifar")


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown architecture {name!r}; known: {sorted(_MODULES)}")
    cfg = importlib.import_module(_MODULES[name]).CONFIG
    return cfg.reduced() if reduced else cfg


def get_shape(name: str) -> InputShape:
    return INPUT_SHAPES[name]
