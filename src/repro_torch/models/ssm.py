"""Mamba2 (SSD, state-space duality) mixer block, arXiv:2405.21060 (port of
``repro/models/ssm.py``).

Training and prefill use the chunked SSD algorithm: inside a chunk the
output is a masked, decay-weighted attention-like product; across chunks a
constant-size recurrent state (B, H, P, N) is carried by a loop over the
chunks (``repro``'s ``lax.scan``).  Decode is the pure recurrence, O(1) in
the sequence length.

Shapes: d_inner = expand * d_model, H = d_inner // head_dim (P),
N = ssm_state, one group (B/C shared across heads).

Precision follows ``repro``'s: its einsums keep bf16 operands with f32
accumulation (``preferred_element_type``), which here are products of the
operands widened to f32 (a bf16 product is exact in f32, so only the
order of the f32 sums differs); the operands are rounded to the model
dtype exactly where ``repro`` casts them, and nowhere else.  The decay and
cumsum math is f32.

Decode writes the ``conv`` and ``state`` caches in place, as the
attention caches are written (``models/transformer.py``).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, rmsnorm_noscale


def ssm_dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    return d_inner, d_inner // cfg.ssm_head_dim


def ssm_init(gen, cfg, dtype):
    d = cfg.d_model
    d_inner, h = ssm_dims(cfg)
    n, w = cfg.ssm_state, cfg.ssm_conv_width
    conv_ch = d_inner + 2 * n  # x, B and C all pass through the causal conv
    dev = gen.device
    # A in the (-exp) parametrisation; dt_bias such that softplus(dt_bias)
    # ~ U[1e-3, 1e-1] in log space, from repro's fixed numpy stream
    dt = np.exp(np.random.RandomState(0).uniform(np.log(1e-3), np.log(1e-1), size=(h,))
                ).astype(np.float32)
    dt_bias = dt + np.log(-np.expm1(-dt))  # inverse softplus
    return {
        "in_proj": dense_init(gen, (d, d_inner * 2 + 2 * n + h), d, dtype),
        "conv_w": (torch.randn((w, conv_ch), generator=gen, device=dev)
                   * (1.0 / np.sqrt(w))).to(dtype),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=dev),
        "A_log": torch.log(torch.arange(1, h + 1, dtype=torch.float32, device=dev)),
        "dt_bias": torch.from_numpy(dt_bias).to(dev),
        "D": torch.ones((h,), dtype=torch.float32, device=dev),
        "norm_scale": torch.zeros((d_inner,), dtype=dtype, device=dev),
        "out_proj": dense_init(gen, (d_inner, d), d_inner, dtype,
                               scale=1.0 / np.sqrt(2 * max(1, cfg.n_layers))),
    }


def _split_proj(p, cfg, x):
    """x: (B,S,D) -> z (B,S,d_inner), xBC (B,S,d_inner+2N), dt (B,S,H)."""
    d_inner, _ = ssm_dims(cfg)
    n = cfg.ssm_state
    zxbcdt = x @ p["in_proj"]
    return (zxbcdt[..., :d_inner], zxbcdt[..., d_inner:2 * d_inner + 2 * n],
            zxbcdt[..., 2 * d_inner + 2 * n:])


def _causal_conv(p, xbc, width):
    """Depthwise causal conv over the sequence axis.  xbc: (B,S,C)."""
    s = xbc.shape[1]
    pad = F.pad(xbc, (0, 0, width - 1, 0))
    out = 0
    for i in range(width):  # repro's sum(...) order, from 0
        out = out + pad[:, i:i + s, :] * p["conv_w"][i][None, None, :]
    return F.silu(out + p["conv_b"][None, None, :])


def _segsum(da):
    """Log-decay matrix: L[t, s] = sum_{s < u <= t} da[u], -inf for s > t.
    da: (..., L) f32 -> (..., L, L)."""
    n = da.shape[-1]
    cs = torch.cumsum(da, dim=-1)
    mat = cs[..., :, None] - cs[..., None, :]  # decay strictly after step s
    mask = torch.tril(torch.ones((n, n), dtype=torch.bool, device=da.device))
    return torch.where(mask, mat, -torch.inf)


def _f32(x, dtype):
    """x rounded to ``dtype`` (where ``repro`` casts), then widened to f32
    for an f32-accumulating product."""
    return x.to(dtype).float()


def ssd_chunked(cfg, xh, Bm, Cm, dt_soft, A):
    """Chunked SSD scan.

    xh: (B,S,H,P)  Bm, Cm: (B,S,N)  dt_soft: (B,S,H) f32  A: (H,) f32 (< 0).
    Returns y (B,S,H,P) f32 and the final state (B,H,P,N) f32."""
    b, s, h, pdim = xh.shape
    n = Bm.shape[-1]
    L = min(cfg.ssm_chunk, s)
    while s % L:
        L //= 2
    nc = s // L

    dtype = xh.dtype
    xc = xh.reshape(b, nc, L, h, pdim)
    Bc = Bm.reshape(b, nc, L, n)
    Cc = Cm.reshape(b, nc, L, n)
    dtc = dt_soft.reshape(b, nc, L, h)
    da = (dt_soft * A[None, None, :]).reshape(b, nc, L, h)  # f32, <= 0

    # -- intra-chunk (attention-like, masked decay) --
    ldec = _segsum(da.movedim(-1, -2))  # (B,c,H,L,L)
    scores = torch.einsum("bcln,bcmn->bclm", Cc.float(), Bc.float())  # shared over H
    w = scores[:, :, None, :, :] * torch.exp(ldec)  # (B,c,H,L,L) f32
    xdt = xc * dtc.to(dtype)[..., None]  # (B,c,L,H,P), rounded to dtype as in repro
    y_intra = torch.einsum("bchlm,bcmhp->bclhp", _f32(w, dtype), xdt.float())

    # -- chunk-final states --
    cum = torch.cumsum(da, dim=2)  # (B,c,L,H)
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)  # (B,c,L,H)
    states = torch.einsum("bclh,bcln,bclhp->bchpn", _f32(decay_to_end * dtc, dtype),
                          Bc.float(), xc.float())

    # -- inter-chunk recurrence over the chunk index --
    chunk_decay = torch.exp(cum[:, :, -1, :])  # (B,c,H): a chunk's total decay
    hcur = torch.zeros((b, h, pdim, n), dtype=torch.float32, device=xh.device)
    h_in = []
    for c in range(nc):
        h_in.append(hcur)  # the state entering chunk c
        hcur = hcur * chunk_decay[:, c, :, None, None] + states[:, c]
    h_in = torch.stack(h_in, dim=1)  # (B,c,H,P,N)

    # -- contribution of the carried state --
    in_decay = torch.exp(cum)  # (B,c,L,H): decay from the chunk start to step t
    y_inter = torch.einsum("bcln,bchpn,bclh->bclhp", Cc.float(), _f32(h_in, dtype),
                           _f32(in_decay, dtype))

    return (y_intra + y_inter).reshape(b, s, h, pdim), hcur


def _mix(p, cfg, x, xbc, z, dt):
    """The SSD scan and the gated output over the conv's output ``xbc``;
    returns (out (B,S,D), final state)."""
    d_inner, h = ssm_dims(cfg)
    n, pdim = cfg.ssm_state, cfg.ssm_head_dim
    b, s, _ = x.shape
    xs = xbc[..., :d_inner].reshape(b, s, h, pdim)
    Bm = xbc[..., d_inner:d_inner + n]
    Cm = xbc[..., d_inner + n:]
    dt_soft = F.softplus(dt.float() + p["dt_bias"][None, None, :])
    A = -torch.exp(p["A_log"])
    y, h_final = ssd_chunked(cfg, xs, Bm, Cm, dt_soft, A)
    y = y + p["D"][None, None, :, None] * xs.float()
    return _gate_out(p, cfg, y.reshape(b, s, d_inner).to(x.dtype), z), h_final


def _gate_out(p, cfg, y, z):
    """y * silu(z), the scale-free RMSNorm times (1 + norm_scale), out_proj."""
    y = y * F.silu(z)
    y = rmsnorm_noscale(y, cfg.norm_eps) * (1.0 + p["norm_scale"].float()).to(y.dtype)
    return y @ p["out_proj"]


def ssm_forward(p, cfg, x):
    """Training / prefill pass.  x: (B,S,D) normed -> (B,S,D)."""
    z, xbc, dt = _split_proj(p, cfg, x)
    return _mix(p, cfg, x, _causal_conv(p, xbc, cfg.ssm_conv_width), z, dt)[0]


# ---------------------------------------------------------------------------
# Decode path (recurrent, O(1) per token)
# ---------------------------------------------------------------------------


def ssm_init_cache(cfg, batch, dtype, device):
    d_inner, h = ssm_dims(cfg)
    n, w = cfg.ssm_state, cfg.ssm_conv_width
    return {
        "conv": torch.zeros((batch, w - 1, d_inner + 2 * n), dtype=dtype, device=device),
        "state": torch.zeros((batch, h, cfg.ssm_head_dim, n), dtype=torch.float32,
                             device=device),
    }


def ssm_decode(p, cfg, x, cache):
    """One-token recurrent step.  x: (B,1,D) -> (out (B,1,D), cache), the
    cache's ``conv`` and ``state`` updated in place."""
    d_inner, h = ssm_dims(cfg)
    n, pdim = cfg.ssm_state, cfg.ssm_head_dim
    b = x.shape[0]

    z, xbc, dt = _split_proj(p, cfg, x)  # (B,1,*)
    window = torch.cat([cache["conv"], xbc], dim=1)  # (B,w,C)
    conv_out = (window * p["conv_w"][None, :, :]).sum(dim=1) + p["conv_b"]
    xbc1 = F.silu(conv_out)  # (B,C)

    xs = xbc1[:, :d_inner].reshape(b, h, pdim).float()
    Bm = xbc1[:, d_inner:d_inner + n].float()
    Cm = xbc1[:, d_inner + n:].float()
    dt_soft = F.softplus(dt[:, 0].float() + p["dt_bias"][None, :])  # (B,H)
    decay = torch.exp(dt_soft * -torch.exp(p["A_log"])[None, :])  # (B,H)

    state = cache["state"] * decay[:, :, None, None] + torch.einsum(
        "bh,bn,bhp->bhpn", dt_soft, Bm, xs)
    y = torch.einsum("bn,bhpn->bhp", Cm, state) + p["D"][None, :, None] * xs
    cache["conv"].copy_(window[:, 1:, :])
    cache["state"].copy_(state)
    return _gate_out(p, cfg, y.reshape(b, 1, d_inner).to(x.dtype), z), cache


def ssm_forward_with_cache(p, cfg, x):
    """Prefill pass that also returns the decode cache: the conv buffer (the
    last w - 1 pre-activation projections, as decode keeps it) and the
    final recurrent state."""
    w = cfg.ssm_conv_width
    s = x.shape[1]
    z, xbc_pre, dt = _split_proj(p, cfg, x)
    out, h_final = _mix(p, cfg, x, _causal_conv(p, xbc_pre, w), z, dt)
    conv_tail = (xbc_pre[:, -(w - 1):, :] if s >= w - 1
                 else F.pad(xbc_pre, (0, 0, w - 1 - s, 0)))
    return out, {"conv": conv_tail.contiguous(), "state": h_final}
