"""Model configs: stdlib-only copies of ``repro.configs`` (``base`` byte
for byte; each arch module differs only in its import line).

``get_config("gemma3-1b")`` returns the full config and
``get_config("gemma3-1b", reduced=True)`` the CPU-smoke variant, as in
``repro``.  The port serves the dense text archs; the MoE, SSM, hybrid
and frontend archs keep their names in ``ARCH_NAMES`` and raise
``NotImplementedError`` until their slice is ported.
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
    "musicgen-large": None,
    "granite-3-2b": "repro_torch.configs.granite_3_2b",
    "granite-3-8b": "repro_torch.configs.granite_3_8b",
    "mamba2-2.7b": None,
    "zamba2-2.7b": None,
    "olmoe-1b-7b": None,
    "gemma2-9b": "repro_torch.configs.gemma2_9b",
    "granite-moe-1b-a400m": None,
    "internvl2-2b": None,
    "resnet-cifar": "repro_torch.configs.resnet_cifar",
}

ARCH_NAMES = tuple(n for n in _MODULES if n != "resnet-cifar")
DENSE_ARCH_NAMES = tuple(n for n in ARCH_NAMES if _MODULES[n] is not None)


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown architecture {name!r}; known: {sorted(_MODULES)}")
    if _MODULES[name] is None:
        raise NotImplementedError(
            f"{name}: only the dense text archs {DENSE_ARCH_NAMES} are ported; "
            "MoE, SSM, hybrid and frontend archs are ROADMAP.md queue 1, item 14")
    cfg = importlib.import_module(_MODULES[name]).CONFIG
    return cfg.reduced() if reduced else cfg


def get_shape(name: str) -> InputShape:
    return INPUT_SHAPES[name]
