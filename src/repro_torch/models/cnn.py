"""ResNet-family CNN for the paper-faithful pFedSOP reproduction.

Port of ``repro/models/cnn.py``: the same functional model over the same
nested-dict params in the JAX layout — conv weights HWIO, activations
NHWC at ``apply``'s boundary, ``blocks`` a tuple — so a parameter tree
carries across frameworks unchanged (``repro_torch.weights``).  Inside,
weights are permuted to OIHW and activations to NCHW for ATen/cuDNN.

Two numerics points the port must match:

- SAME padding is computed per conv from the input size, kernel and
  stride, as XLA does.  At stride 2 it is asymmetric (a 3x3 conv on a
  32-wide input pads (0, 1)), which ``padding=1`` would get wrong by a
  one-pixel shift; such convs pad explicitly with ``F.pad``.
- GroupNorm: ``g = min(8, c)`` decremented until it divides c,
  contiguous channel groups, population variance, eps 1e-5.

No conv or norm here has a hand-written kernel: ``repro`` leaves them to
XLA, and the port leaves them to ATen/cuDNN.  Callers comparing against
``repro`` on a GPU disable TF32 (``torch.backends.cudnn.allow_tf32``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import tree_map


def _same_pads(size: int, k: int, stride: int):
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(x, w, stride=1):
    """x: (B, C, H, W) NCHW; w: (kh, kw, Cin, Cout) HWIO; SAME padding."""
    kh, kw = w.shape[0], w.shape[1]
    ph = _same_pads(x.shape[-2], kh, stride)
    pw = _same_pads(x.shape[-1], kw, stride)
    w = w.permute(3, 2, 0, 1)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, w, stride=stride, padding=(ph[0], pw[0]))
    return F.conv2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), w, stride=stride)


def groupnorm(p, x, groups=8, eps=1e-5):
    b, c, h, w = x.shape
    g = min(groups, c)
    while c % g:
        g -= 1
    xg = x.reshape(b, g, c // g, h, w)
    mean = xg.mean(dim=(2, 3, 4), keepdim=True)
    var = xg.var(dim=(2, 3, 4), unbiased=False, keepdim=True)
    x = ((xg - mean) * torch.rsqrt(var + eps)).reshape(b, c, h, w)
    return x * p["scale"][None, :, None, None] + p["bias"][None, :, None, None]


def _conv_init(gen, kh, kw, cin, cout):
    std = math.sqrt(2.0 / (kh * kw * cin))
    return torch.randn((kh, kw, cin, cout), generator=gen) * std


def _gn_init(c):
    return {"scale": torch.ones(c), "bias": torch.zeros(c)}


def _block_init(gen, cin, cout):
    p = {
        "conv1": _conv_init(gen, 3, 3, cin, cout),
        "gn1": _gn_init(cout),
        "conv2": _conv_init(gen, 3, 3, cout, cout),
        "gn2": _gn_init(cout),
    }
    if cin != cout:
        p["proj"] = _conv_init(gen, 1, 1, cin, cout)
    return p


def init_params(gen: torch.Generator, cfg, device="cuda"):
    """Same shapes and distributions as ``repro.models.cnn.init_params``
    (``jax.random`` bits cannot be reproduced; parity tests carry JAX
    params across with ``repro_torch.weights``).  Drawn on the CPU from
    ``gen``, then moved to ``device``."""
    dev = resolve_device(device)
    chans = cfg.cnn_channels
    params = {
        "stem": _conv_init(gen, 3, 3, cfg.cnn_in_channels, chans[0]),
        "stem_gn": _gn_init(chans[0]),
    }
    blocks, cin = [], chans[0]
    for cout in chans:
        blocks.append(_block_init(gen, cin, cout))
        cin = cout
    params["blocks"] = tuple(blocks)
    params["fc_w"] = torch.randn((cin, cfg.n_classes), generator=gen) / math.sqrt(cin)
    params["fc_b"] = torch.zeros(cfg.n_classes)
    return tree_map(lambda x: x.to(dev), params)


def _block_apply(p, x, stride):
    h = F.relu(groupnorm(p["gn1"], conv2d(x, p["conv1"], stride)))
    h = groupnorm(p["gn2"], conv2d(h, p["conv2"]))
    if "proj" in p:
        x = conv2d(x, p["proj"], stride)
    elif stride != 1:
        x = x[:, :, ::stride, ::stride]
    return F.relu(h + x)


def apply(params, cfg, images):
    """images: (B, H, W, C) f32 NHWC -> logits (B, n_classes)."""
    x = images.permute(0, 3, 1, 2)
    x = F.relu(groupnorm(params["stem_gn"], conv2d(x, params["stem"])))
    for i, bp in enumerate(params["blocks"]):
        x = _block_apply(bp, x, 1 if i == 0 else 2)
    x = x.mean(dim=(2, 3))  # global average pool
    return x @ params["fc_w"] + params["fc_b"]


def loss_fn(params, cfg, batch):
    """Categorical cross-entropy (the paper's probabilistic objective)."""
    logits = apply(params, cfg, batch["images"]).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, batch["labels"].long()[:, None])[:, 0]
    return (logz - gold).mean()


def accuracy(params, cfg, batch):
    logits = apply(params, cfg, batch["images"])
    return (logits.argmax(-1) == batch["labels"]).float().mean()
