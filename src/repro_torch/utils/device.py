"""Device resolution for the port's entry points.

Every entry point takes ``device`` and defaults to the card.  There is no
silent fallback: asking for CUDA on a machine without it raises, and a
CPU run must say ``device="cpu"`` explicitly (the tests do).
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but torch.cuda.is_available() "
            "is False; repro_torch never falls back to the CPU — pass "
            "device='cpu' explicitly for a CPU run"
        )
    return dev
