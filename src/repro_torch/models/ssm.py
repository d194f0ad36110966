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

Tensor-parallel serving (``tp``, a ``models/parallel.py``
``TensorParallel``): a rank holds the cuts ``launch/sharding.py``'s rules
give it, each leaf whole where its dim does not divide: ``in_proj`` on Z,
``conv_w``/``conv_b`` and the ``conv`` cache on the conv channels C,
``out_proj`` on ``d_inner`` and the ``state`` cache on the heads.  The
cuts do not follow the z / x / B / C / dt segments (rank 0 of m = 2 holds
all of z and the first channels of x), so the mixer runs:

1. ``in_proj`` column-parallel, its output gathered over Z;
2. the depthwise conv and its ``silu`` on this rank's C slice (its
   ``conv_w``/``conv_b``, and in decode its ``conv`` cache slice; prefill
   leaves that slice behind), the output gathered over C;
3. the SSD scan / recurrence on this rank's heads where the heads divide
   (``A_log``, ``dt_bias``, ``D`` and ``norm_scale`` are replicated and
   sliced here), leaving its ``state`` slice; else on every head;
4. the gate, then the scale-free norm over the whole ``d_inner`` with the
   sum of squares all-reduced (``parallel.rms_noscale``) where the heads
   are split;
5. ``out_proj`` row-parallel on its ``d_inner`` rows (the gated output cut
   to them where the heads are whole).

Training, each whole tensor read by split computation enters through
``parallel.enter`` where the split happens (the input of a sliced
``in_proj``, the conv input cut to its channels, the gathered x/B/C and
dt and z read by this rank's heads, the per-head leaves and
``norm_scale`` on its heads, a gated output cut for ``out_proj``), and the
norm statistic's all-reduce has an all-reduce for its backward.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import parallel
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


def _split_proj(p, cfg, x, tp=None):
    """x: (B,S,D) -> z (B,S,d_inner), xBC (B,S,d_inner+2N), dt (B,S,H),
    whole (gathered over Z where ``in_proj`` holds a column slice)."""
    d_inner, h = ssm_dims(cfg)
    n = cfg.ssm_state
    split = tp is not None and parallel.split(tp, p["in_proj"].shape[-1],
                                              2 * d_inner + 2 * n + h)
    zxbcdt = (parallel.enter(x, tp) if split else x) @ p["in_proj"]
    if split:
        zxbcdt = parallel.gather(zxbcdt, tp, -1)
    return (zxbcdt[..., :d_inner], zxbcdt[..., d_inner:2 * d_inner + 2 * n],
            zxbcdt[..., 2 * d_inner + 2 * n:])


def _conv_slice(p, cfg, tp):
    """This rank's slice of the conv channels, or None where ``conv_w`` is
    whole."""
    c = ssm_dims(cfg)[0] + 2 * cfg.ssm_state
    if tp is None or not parallel.split(tp, p["conv_w"].shape[1], c):
        return None
    return tp.slice_of(c)


def _gather_channels(x, tp):
    """The conv's output made whole over its channels (the last dim)."""
    return parallel.gather(x, tp, -1)


def _head_slice(cfg, tp, local=None):
    """This rank's heads where the rules split them (the ``state`` cache
    on H), or None; ``local``: the heads of its ``state`` slice."""
    h = ssm_dims(cfg)[1]
    if tp is None:
        return None
    if local is not None:
        return tp.slice_of(h) if parallel.split(tp, local, h) else None
    return tp.slice_of(h) if tp.size > 1 and h % tp.size == 0 else None


def _conv_tp(p, cfg, xbc, tp):
    """``_causal_conv`` on this rank's channels, gathered over them."""
    cs = _conv_slice(p, cfg, tp)
    if cs is None:
        return _causal_conv(p, xbc, cfg.ssm_conv_width)
    xbc = parallel.enter(xbc, tp)[..., cs]
    return _gather_channels(_causal_conv(p, xbc, cfg.ssm_conv_width), tp)


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


def _per_head(p, hs, tp):
    """(dt_bias, A_log, D) of the heads ``hs`` (all of them for None): the
    replicated leaves read on this rank's heads through ``parallel.enter``."""
    if hs is None:
        return p["dt_bias"], p["A_log"], p["D"]
    return tuple(parallel.enter(p[k], tp)[hs] for k in ("dt_bias", "A_log", "D"))


def _mix(p, cfg, x, xbc, z, dt, tp=None):
    """The SSD scan and the gated output over the conv's output ``xbc``;
    returns (out (B,S,D), final state); with ``tp``, on this rank's heads
    where they are split."""
    d_inner, h = ssm_dims(cfg)
    n, pdim = cfg.ssm_state, cfg.ssm_head_dim
    b, s, _ = x.shape
    hs = _head_slice(cfg, tp)
    if hs is not None:  # the whole x, B, C and dt read by this rank's heads
        xbc, dt = parallel.enter(xbc, tp), parallel.enter(dt, tp)
    xs = xbc[..., :d_inner].reshape(b, s, h, pdim)
    Bm = xbc[..., d_inner:d_inner + n]
    Cm = xbc[..., d_inner + n:]
    if hs is not None:
        xs, dt = xs[:, :, hs], dt[..., hs]
    dt_bias, a_log, d_skip = _per_head(p, hs, tp)
    dt_soft = F.softplus(dt.float() + dt_bias[None, None, :])
    A = -torch.exp(a_log)
    y, h_final = ssd_chunked(cfg, xs, Bm, Cm, dt_soft, A)
    y = y + d_skip[None, None, :, None] * xs.float()
    y = y.reshape(b, s, xs.shape[2] * pdim).to(x.dtype)
    return _gate_out(p, cfg, y, z, tp, hs), h_final


def _gate_out(p, cfg, y, z, tp=None, hs=None):
    """y * silu(z), the scale-free RMSNorm times (1 + norm_scale), out_proj.
    ``hs``: the heads ``y`` holds (this rank's), None for all of them."""
    d_inner = ssm_dims(cfg)[0]
    scale = p["norm_scale"]
    if hs is None:
        y = y * F.silu(z)
        y = rmsnorm_noscale(y, cfg.norm_eps) * (1.0 + scale.float()).to(y.dtype)
    else:
        inner = tp.slice_of(d_inner)  # the heads' rows of d_inner
        y = y * F.silu(parallel.enter(z, tp)[..., inner])
        y = parallel.rms_noscale(y, tp, d_inner, cfg.norm_eps) * \
            (1.0 + parallel.enter(scale, tp)[inner].float()).to(y.dtype)
    if tp is not None and parallel.split(tp, p["out_proj"].shape[0], d_inner):
        if hs is None:  # every head here: cut to this rank's rows
            y = parallel.enter(y, tp)[..., tp.slice_of(d_inner)]
        return parallel.row("...i,id->...d", y, p["out_proj"], tp)
    return y @ p["out_proj"]


def ssm_forward(p, cfg, x, tp=None):
    """Training / prefill pass.  x: (B,S,D) normed -> (B,S,D)."""
    z, xbc, dt = _split_proj(p, cfg, x, tp)
    return _mix(p, cfg, x, _conv_tp(p, cfg, xbc, tp), z, dt, tp)[0]


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


def ssm_decode(p, cfg, x, cache, tp=None):
    """One-token recurrent step.  x: (B,1,D) -> (out (B,1,D), cache), the
    cache's ``conv`` and ``state`` updated in place; with ``tp``, this
    rank's slices of them."""
    d_inner, h = ssm_dims(cfg)
    n, pdim = cfg.ssm_state, cfg.ssm_head_dim
    b = x.shape[0]

    z, xbc, dt = _split_proj(p, cfg, x, tp)  # (B,1,*)
    cs = _conv_slice(p, cfg, tp)
    window = torch.cat([cache["conv"], xbc if cs is None else xbc[..., cs]], dim=1)  # (B,w,C)
    conv_out = (window * p["conv_w"][None, :, :]).sum(dim=1) + p["conv_b"]
    xbc1 = F.silu(conv_out)  # (B,C)
    if cs is not None:
        xbc1 = _gather_channels(xbc1, tp)

    hs = _head_slice(cfg, tp, cache["state"].shape[1])
    xs = xbc1[:, :d_inner].reshape(b, h, pdim).float()
    dt = dt[:, 0]
    if hs is not None:
        xs, dt = xs[:, hs], dt[:, hs]
    dt_bias, a_log, d_skip = _per_head(p, hs, tp)
    Bm = xbc1[:, d_inner:d_inner + n].float()
    Cm = xbc1[:, d_inner + n:].float()
    dt_soft = F.softplus(dt.float() + dt_bias[None, :])  # (B,H)
    decay = torch.exp(dt_soft * -torch.exp(a_log)[None, :])  # (B,H)

    state = cache["state"] * decay[:, :, None, None] + torch.einsum(
        "bh,bn,bhp->bhpn", dt_soft, Bm, xs)
    y = torch.einsum("bn,bhpn->bhp", Cm, state) + d_skip[None, :, None] * xs
    cache["conv"].copy_(window[:, 1:, :])
    cache["state"].copy_(state)
    y = y.reshape(b, 1, xs.shape[1] * pdim).to(x.dtype)
    return _gate_out(p, cfg, y, z, tp, hs), cache


def ssm_forward_with_cache(p, cfg, x, tp=None):
    """Prefill pass that also returns the decode cache: the conv buffer (the
    last w - 1 pre-activation projections, as decode keeps it) and the
    final recurrent state; with ``tp``, this rank's slices of them."""
    w = cfg.ssm_conv_width
    s = x.shape[1]
    z, xbc_pre, dt = _split_proj(p, cfg, x, tp)
    out, h_final = _mix(p, cfg, x, _conv_tp(p, cfg, xbc_pre, tp), z, dt, tp)
    cs = _conv_slice(p, cfg, tp)
    if cs is not None:
        xbc_pre = xbc_pre[..., cs]
    conv_tail = (xbc_pre[:, -(w - 1):, :] if s >= w - 1
                 else F.pad(xbc_pre, (0, 0, w - 1 - s, 0)))
    return out, {"conv": conv_tail.contiguous(), "state": h_final}
