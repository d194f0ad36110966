"""Synthetic class-conditional image generator.

CIFAR/TinyImageNet are not available offline, so the paper-faithful
experiments run on a synthetic dataset with the same *shape* and the same
partition statistics: each class c gets a random smooth template
(low-frequency mixture) and samples are template + per-sample noise +
random shift.  The classification task is learnable but not trivial - a
small CNN separates classes in a few epochs, which is exactly what the FL
convergence comparison needs (the paper's claims are about *relative*
convergence speed across FL methods, not absolute CIFAR accuracy; see
DESIGN.md §1 band realism).
"""
from __future__ import annotations

import numpy as np


def make_class_conditional_images(
    n_samples: int,
    n_classes: int,
    image_size: int = 32,
    channels: int = 3,
    noise: float = 0.35,
    seed: int = 0,
):
    """Returns (images (N,H,W,C) f32 in [-1,1]-ish, labels (N,) int32).

    Samples are balanced across classes (n_samples // n_classes each, the
    remainder distributed to the first classes) mirroring CIFAR's balance.
    """
    rng = np.random.RandomState(seed)
    h = w = image_size

    # low-frequency class templates: sum of a few random 2-D cosines
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    templates = np.zeros((n_classes, h, w, channels), np.float32)
    for c in range(n_classes):
        for _ in range(4):
            fy, fx = rng.uniform(0.5, 3.0, 2)
            phase = rng.uniform(0, 2 * np.pi, 2)
            amp = rng.uniform(0.4, 1.0)
            ch_w = rng.uniform(-1, 1, channels)
            base = amp * np.cos(2 * np.pi * fy * yy / h + phase[0]) * np.cos(
                2 * np.pi * fx * xx / w + phase[1]
            )
            templates[c] += base[:, :, None] * ch_w[None, None, :]
    templates /= np.abs(templates).max(axis=(1, 2, 3), keepdims=True) + 1e-6

    counts = np.full(n_classes, n_samples // n_classes)
    counts[: n_samples % n_classes] += 1
    labels = np.repeat(np.arange(n_classes), counts).astype(np.int32)
    rng.shuffle(labels)

    images = np.empty((n_samples, h, w, channels), np.float32)
    for i, c in enumerate(labels):
        sy, sx = rng.randint(-2, 3, 2)
        t = np.roll(np.roll(templates[c], sy, axis=0), sx, axis=1)
        images[i] = t + noise * rng.randn(h, w, channels)
    return images, labels
