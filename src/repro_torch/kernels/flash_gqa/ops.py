"""Public wrappers: causal GQA flash attention (K5 forward, K6/K7 backward).

Layouts are ``repro.kernels.flash_gqa.ops.flash_gqa``'s model layout:
q (B, S, H, D), k/v (B, S, KV, D); the per-row LSE residual and
``delta = rowsum(dO * out)`` are (B, H, S) f32.  Each wrapper launches
its kernel for CUDA tensors and runs its plain PyTorch version
(``*_plain``, the whole (S, S) score matrix at once) for CPU tensors:

  ``flash_fwd``      K5: (out, lse);
  ``flash_bwd_dq``   K6: dq;
  ``flash_bwd_dkv``  K7: (dk, dv).

Which kernel runs is a dispatch by dtype, not a fallback: bf16 (the LM
slice's type) runs K5-K7 on the tensor cores (``csrc/flash_gqa_sm90.cu``:
at head_dim 64, 80 and 128 K5 ``fwd_narrow_kernel``, the persistent
kernel on 128-key tiles at the true width, and K6 and K7
``dq_narrow_kernel`` and ``dkv_narrow_kernel``; at 256 ``fwd_kernel``,
``dq_kernel`` and ``dkv_kernel``; at G = H / KV > 1, K7
writes per-head f32 partials and
``flash_bwd_dkv_sum`` adds them in head order); f32 runs
``csrc/flash_gqa.cu``: K5-K7 at 256 on its SIMT kernels (products in f32 on
the CUDA cores); at head_dim 64, 80 and 128 on the tensor cores, each f32
product as three TF32 products of the operands split into hi and lo halves,
so f32-accurate: K5 (``TF32_FWD_HEAD_DIMS``) ``fwd_tf32_kernel`` (mma.sync,
the online softmax in registers), K6 and K7 (``TF32_HEAD_DIMS``; G folded
inside K7, no sum pass) at 64 (``WGMMA_HEAD_DIMS``) ``dq_wgmma_kernel`` and
``dkv_wgmma_kernel`` (wgmma, a producer warpgroup writing each streamed
tile's split copies), at 80 and 128 ``dq_tf32_kernel`` and
``dkv_tf32_kernel`` (mma.sync).  A failed build or launch raises.  The bf16
kernels round P, dS (K6) and P^T, dS^T (K7) to
bf16 for the tensor cores; ``flash_bwd_dq_wide`` and
``flash_bwd_dkv_partials`` return their f32 sums before the final
rounding, so ``chip_smoke.py`` can hold that departure to a bound.

``flash_gqa(q, k, v, window, softcap, scale, impl)`` is the
differentiable entry: an ``autograd.Function`` whose forward is K5 and
whose backward is K6 + K7, with delta a torch op between them as
``repro`` computes it outside its kernels.  "reference" runs the oracle
(``ref.flash_gqa_ref``) under plain autograd.  ``LAUNCHES`` counts kernel
launches (never plain calls), one key a kernel: ``flash_<kind>`` for the
bf16 kernels of ``flash_gqa_sm90.cu``, ``flash_<kind>_f32`` for the f32
ones of ``flash_gqa.cu`` (``launch_key``); the K7 sum pass has its own key.

A meta tensor takes the CUDA path up to each launch: the same checks, the
same outputs and scratch (the LSE; K7's f32 head partials and its sum pass
at G > 1 in bf16), and in place of the launch a record of it, with its cost,
in ``repro_torch.kernels.meta`` (the dry run's shape-and-cost model; never
in ``LAUNCHES``).

The kernels take the canonical positions arange(S): key j is visible to
query i iff j <= i and i - j < window.  Masked scores are NEG_INF in the
plain versions, as in ``repro``; the CUDA kernels keep them out of exp.

K5 also runs at a query offset (``q0``, a rank of the sequence-parallel
prefill, ``models/attention.py``): q (B, Sq, H, D) holds the queries at
positions q0 .. q0 + Sq - 1 of the S keys of k/v (q0 + Sq <= S), out is
(B, Sq, H, D) and the LSE (B, H, Sq); the mask and the kernels' key-tile
ranges are computed on those positions.  On the card q0 must be a
multiple of the query tile (``grid.SM90_FWD_ROWS``); the plain version
takes any.  K6 and K7 take no offset: a backward through an offset
forward raises (ROADMAP.md section 3, R7: no sequence-parallel backward).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import costs, meta
from repro_torch.kernels.build import bind, check_launch
from repro_torch.kernels.dispatch import check_impl, kernel_scope
from repro_torch.kernels.flash_gqa.grid import SM90_FWD_ROWS
from repro_torch.kernels.flash_gqa.ref import NEG_INF, flash_gqa_ref, visible_mask

SOURCE = Path(__file__).parent / "csrc" / "flash_gqa.cu"
SM90_SOURCE = Path(__file__).parent / "csrc" / "flash_gqa_sm90.cu"
LAUNCHES = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0, "flash_bwd_dkv_sum": 0,
            "flash_fwd_f32": 0, "flash_bwd_dq_f32": 0, "flash_bwd_dkv_f32": 0}
HEAD_DIMS = (64, 80, 128, 256)
FWD_NARROW_HEAD_DIMS = (64, 80, 128)  # bf16 K5 runs fwd_narrow_kernel
NARROW_HEAD_DIMS = (64, 80, 128)  # bf16 K6 and K7 run dq_ and dkv_narrow_kernel
TF32_FWD_HEAD_DIMS = (64, 80, 128)  # f32 K5 runs fwd_tf32_kernel; 256 the SIMT fwd_kernel
TF32_HEAD_DIMS = (64, 80, 128)  # f32 K6 and K7 run on the tensor cores
WGMMA_HEAD_DIMS = (64,)  # ... on dq_ and dkv_wgmma_kernel; 80, 128 on dq_ and dkv_tf32_kernel
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_PTR, _INT, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SHAPE = [_INT] * 7 + [_F32, _F32, _PTR]  # dtype b s h kv d window softcap scale stream
SIGNATURES = {
    "flash_gqa_fwd": ([_PTR] * 5 + [_INT, _INT] + _SHAPE, _INT),  # + sq, q0
    "flash_gqa_bwd_dq": ([_PTR] * 7 + _SHAPE, _INT),
    "flash_gqa_bwd_dkv": ([_PTR] * 8 + _SHAPE, _INT),
    "flash_gqa_error_string": ([_INT], ctypes.c_char_p),
}
SM90_SIGNATURES = {
    "flash_gqa_sm90_fwd": ([_PTR] * 5 + [_INT, _INT] + _SHAPE, _INT),  # + sq, q0
    "flash_gqa_sm90_bwd_dq": ([_PTR] * 7 + [_INT] + _SHAPE, _INT),  # + dq's dtype
    "flash_gqa_sm90_bwd_dkv": ([_PTR] * 8 + _SHAPE, _INT),
    "flash_gqa_sm90_dkv_sum": ([_PTR] * 4 + [_INT] * 5 + [_PTR], _INT),
    "flash_gqa_sm90_error_string": ([_INT], ctypes.c_char_p),
}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind(SOURCE, SIGNATURES)


@functools.lru_cache(maxsize=None)
def _sm90_lib() -> ctypes.CDLL:
    return bind(SM90_SOURCE, SM90_SIGNATURES)


def build() -> None:
    """Compile (or load the cached) kernel libraries now."""
    _lib()
    _sm90_lib()


def _scale(d, scale):
    return d ** -0.5 if scale is None else scale


def _check(q, k, v, window, *rows, q0=None, **more):
    """Validate what every kernel takes; returns (B, S, H, KV, D), S the
    keys.  ``q0`` (K5 only): the queries' offset, q (B, Sq, H, D) at
    positions q0 .. q0 + Sq - 1 of the S keys; None: Sq = S, no offset."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"need q (B,S,H,D) and k/v (B,S,KV,D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or h % kv or (q0 is None and sq != s):
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)} "
                         "(same B, S, D; H a multiple of KV)")
    if q0 is not None and not (0 <= q0 and 1 <= sq and q0 + sq <= s):
        raise ValueError(f"queries at positions {q0} .. {q0 + sq - 1} do not lie within the "
                         f"{s} keys")
    if q0 and (q.is_cuda or q.is_meta) and q0 % SM90_FWD_ROWS:
        raise ValueError(f"the kernels take a query offset that is a multiple of the query "
                         f"tile ({SM90_FWD_ROWS}), got {q0}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    for t in (q, k, v) + tuple(more.values()):
        if t.dtype not in _DTYPE_CODES or t.dtype != q.dtype:
            raise ValueError(f"q/k/v and their gradients must all be float32 or all "
                             f"bfloat16, got {t.dtype} beside {q.dtype}")
    for name, t in more.items():
        if t.shape != (q if name in ("out", "dout") else k).shape:
            raise ValueError(f"{name} {tuple(t.shape)} has the wrong shape")
    for t in rows:
        if t.shape != (b, h, s) or t.dtype != torch.float32:
            raise ValueError(f"lse/delta must be (B, H, S) float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    for t in (q, k, v) + rows + tuple(more.values()):
        if t.device != q.device:
            raise ValueError(f"operands on {t.device} and {q.device}")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    if (q.is_cuda or q.is_meta) and d not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernels take head_dim in {HEAD_DIMS}, got {d}")
    return b, s, h, kv, d


_COSTS = {"fwd": costs.flash_fwd_cost, "bwd_dq": costs.flash_dq_cost,
          "bwd_dkv": costs.flash_dkv_cost}


def launch_key(kind, dtype):
    """The ``LAUNCHES`` key of a ``kind`` launch ("fwd", "bwd_dq" or
    "bwd_dkv") on ``dtype``: bf16 and f32 run different kernels."""
    return f"flash_{kind}" if dtype == torch.bfloat16 else f"flash_{kind}_f32"


def _launch(kind, tensors, *extra, dtype, b, s, h, kv, d, window, softcap, scale,
            offset=None):
    """Launch ``flash_gqa_<kind>`` (bf16: ``flash_gqa_sm90_<kind>``) on the
    pointers of ``tensors`` and ``extra`` (the forward's Sq and q0, the
    sm90 dq pass's output dtype) and count it under ``launch_key``; on
    meta tensors record it with its cost (``offset``: the forward's
    {"q0", "sq"}) instead."""
    key = launch_key(kind, dtype)
    if tensors[0].is_meta:
        meta.launch(key, _COSTS[kind](b, s, h, kv, d, window, dtype.itemsize, **(offset or {})))
        return
    lib, prefix = ((_sm90_lib(), "flash_gqa_sm90") if dtype == torch.bfloat16
                   else (_lib(), "flash_gqa"))
    name = f"{prefix}_{kind}"
    with torch.cuda.device(tensors[0].device):
        err = getattr(lib, name)(*(t.data_ptr() for t in tensors), *extra,
                                 _DTYPE_CODES[dtype], b, s, h, kv, d, window or 0,
                                 softcap or 0.0, scale, torch.cuda.current_stream().cuda_stream)
    check_launch(lib, err, name, prefix)
    LAUNCHES[key] += 1


# -- plain versions ----------------------------------------------------------


def _scores(q, k, window, softcap, scale, q0=0):
    """Scaled, softcapped, masked f32 scores (B, KV, G, Sq, Sk), the raw
    tanh (for the softcap's chain factor, or None), and q*scale grouped as
    (B, Sq, KV, G, D); the queries at positions q0 .. q0 + Sq - 1."""
    b, sq, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    qs = (q.float() * scale).reshape(b, sq, kv, h // kv, d)
    sc = torch.einsum("bqkgd,btkd->bkgqt", qs, k.float())
    t = None
    if softcap is not None:
        t = torch.tanh(sc / softcap)
        sc = softcap * t
    sc = sc.masked_fill(~visible_mask(s, window, q.device, q0, sq), NEG_INF)
    return sc, t, qs


def flash_fwd_plain(q, k, v, window=None, softcap=None, scale=None, q0=0):
    """Plain K5: (out (B,Sq,H,D) in q's dtype, lse (B,H,Sq) f32), the
    queries at positions q0 .. q0 + Sq - 1 of k/v's S."""
    b, sq, h, d = q.shape
    sc, _, _ = _scores(q, k, window, softcap, _scale(d, scale), q0)
    lse = torch.logsumexp(sc, dim=-1)
    p = torch.exp(sc - lse[..., None])
    out = torch.einsum("bkgqt,btkd->bqkgd", p, v.float()).reshape(b, sq, h, d)
    return out.to(q.dtype), lse.reshape(b, h, sq)


def _probs_and_dscores(q, k, v, dout, lse, delta, window, softcap, scale):
    b, s, h, d = q.shape
    kv = k.shape[2]
    sc, t, qs = _scores(q, k, window, softcap, scale)
    shape = (b, kv, h // kv, s, 1)
    p = torch.exp(sc - lse.reshape(shape))
    do = dout.float().reshape(b, s, kv, h // kv, d)
    dp = torch.einsum("bqkgd,btkd->bkgqt", do, v.float())
    ds = p * (dp - delta.reshape(shape))
    if t is not None:
        ds = ds * (1.0 - t * t)
    return p, ds, qs, do


def flash_bwd_dq_plain(q, k, v, dout, lse, delta, window=None, softcap=None, scale=None):
    """Plain K6: dq (B,S,H,D) in q's dtype."""
    b, s, h, d = q.shape
    sc = _scale(d, scale)
    _, ds, _, _ = _probs_and_dscores(q, k, v, dout, lse, delta, window, softcap, sc)
    dq = torch.einsum("bkgqt,btkd->bqkgd", ds, k.float()) * sc
    return dq.reshape(b, s, h, d).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, dout, lse, delta, window=None, softcap=None, scale=None):
    """Plain K7: (dk, dv) (B,S,KV,D) in k's dtype."""
    sc = _scale(q.shape[-1], scale)
    p, ds, qs, do = _probs_and_dscores(q, k, v, dout, lse, delta, window, softcap, sc)
    dk = torch.einsum("bkgqt,bqkgd->btkd", ds, qs)
    dv = torch.einsum("bkgqt,bqkgd->btkd", p, do)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dkv_sum_plain(pk, pv, kv):
    """Plain K7 sum pass: (dk, dv) (B,S,KV,D) bf16 from f32 per-head
    partials (B,S,H,D), the G heads of each KV head added in order."""
    def one(p):
        b, s, h, d = p.shape
        x = p.reshape(b, s, kv, h // kv, d)
        acc = x[:, :, :, 0]
        for g in range(1, h // kv):
            acc = acc + x[:, :, :, g]
        return acc.to(torch.bfloat16)
    return one(pk), one(pv)


# -- wrappers ----------------------------------------------------------------


def flash_fwd(q, k, v, window=None, softcap=None, scale=None, q0=None):
    """K5 on the card for CUDA tensors; the plain version for CPU ones.
    ``q0``: the position of q's first row among k/v's (module docstring);
    None: q and k/v hold the same S positions.  bf16 at head_dim 64, 80 and
    128 (``FWD_NARROW_HEAD_DIMS``) takes a positive scale only: its kernel
    takes the row max on the raw scores."""
    b, s, h, kv, d = _check(q, k, v, window, q0=q0)
    q0 = q0 or 0
    if not (q.is_cuda or q.is_meta):
        return flash_fwd_plain(q, k, v, window, softcap, scale, q0)
    if q.dtype == torch.bfloat16 and d in FWD_NARROW_HEAD_DIMS and not _scale(d, scale) > 0:
        raise ValueError(f"the bf16 forward at head_dim {d} takes a positive scale, got {scale}")
    sq = q.shape[1]
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    _launch("fwd", (q, k, v, out, lse), sq, q0, dtype=q.dtype, b=b, s=s, h=h, kv=kv, d=d,
            window=window, softcap=softcap, scale=_scale(d, scale),
            offset={"q0": q0, "sq": sq})
    return out, lse


def _dq(q, k, v, dout, lse, delta, window, softcap, scale, dq_dtype):
    """Launch K6 into a new dq of ``dq_dtype`` (the bf16 kernel takes that
    dtype as an argument; the f32 one writes f32)."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    dq = torch.empty(q.shape, dtype=dq_dtype, device=q.device)
    extra = (_DTYPE_CODES[dq_dtype],) if q.dtype == torch.bfloat16 else ()
    _launch("bwd_dq", (q, k, v, dout, lse, delta, dq), *extra, dtype=q.dtype, b=b, s=s,
            h=h, kv=kv, d=d, window=window, softcap=softcap, scale=_scale(d, scale))
    return dq


def flash_bwd_dq(q, k, v, dout, lse, delta, window=None, softcap=None, scale=None):
    """K6 on the card for CUDA tensors; the plain version for CPU ones."""
    _check(q, k, v, window, lse, delta, dout=dout)
    if not (q.is_cuda or q.is_meta):
        return flash_bwd_dq_plain(q, k, v, dout, lse, delta, window, softcap, scale)
    return _dq(q, k, v, dout, lse, delta, window, softcap, scale, q.dtype)


def flash_bwd_dq_wide(q, k, v, dout, lse, delta, window=None, softcap=None, scale=None):
    """bf16 K6 on the card before its final rounding: dq (B,S,H,D) in f32."""
    _check(q, k, v, window, lse, delta, dout=dout)
    if not ((q.is_cuda or q.is_meta) and q.dtype == torch.bfloat16):
        raise ValueError(f"the wide dq comes from bf16 CUDA tensors, got {q.dtype} on "
                         f"{q.device}")
    return _dq(q, k, v, dout, lse, delta, window, softcap, scale, torch.float32)


def flash_bwd_dkv(q, k, v, dout, lse, delta, window=None, softcap=None, scale=None):
    """K7 on the card for CUDA tensors; the plain version for CPU ones."""
    b, s, h, kv, d = _check(q, k, v, window, lse, delta, dout=dout)
    if not (q.is_cuda or q.is_meta):
        return flash_bwd_dkv_plain(q, k, v, dout, lse, delta, window, softcap, scale)
    # bf16 at G > 1: the tensor-core kernel writes f32 per-query-head
    # partials, which the sum pass adds in head order (no atomics)
    if q.dtype == torch.bfloat16 and h > kv:
        return flash_bwd_dkv_sum(*flash_bwd_dkv_partials(q, k, v, dout, lse, delta, window,
                                                         softcap, scale), kv)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("bwd_dkv", (q, k, v, dout, lse, delta, dk, dv), dtype=q.dtype, b=b, s=s, h=h,
            kv=kv, d=d, window=window, softcap=softcap, scale=_scale(d, scale))
    return dk, dv


def flash_bwd_dkv_partials(q, k, v, dout, lse, delta, window=None, softcap=None, scale=None):
    """bf16 K7 at G > 1 on the card, before its sum pass: the f32 dk and dv
    partials of each query head, (B,S,H,D) each."""
    b, s, h, kv, d = _check(q, k, v, window, lse, delta, dout=dout)
    if not ((q.is_cuda or q.is_meta) and q.dtype == torch.bfloat16 and h > kv):
        raise ValueError(f"per-head partials come from bf16 CUDA tensors with H > KV, got "
                         f"{q.dtype} on {q.device}, H={h} KV={kv}")
    dk = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    _launch("bwd_dkv", (q, k, v, dout, lse, delta, dk, dv), dtype=q.dtype, b=b, s=s, h=h,
            kv=kv, d=d, window=window, softcap=softcap, scale=_scale(d, scale))
    return dk, dv


def flash_bwd_dkv_sum(pk, pv, kv):
    """K7's sum pass on the card for CUDA tensors; the plain version for
    CPU ones.  pk, pv: f32 (B,S,H,D) partials -> (dk, dv) (B,S,KV,D) bf16."""
    if (pk.dim() != 4 or pv.shape != pk.shape or pk.shape[2] % kv
            or pk.dtype != torch.float32 or pv.dtype != torch.float32
            or pk.shape[3] % 4 or pv.device != pk.device
            or not (pk.is_contiguous() and pv.is_contiguous())):
        raise ValueError(f"need contiguous f32 partials (B,S,H,D) with H a multiple "
                         f"of {kv} and D of 4, got {tuple(pk.shape)} {pk.dtype}, "
                         f"{tuple(pv.shape)} {pv.dtype}")
    if not (pk.is_cuda or pk.is_meta):
        return flash_bwd_dkv_sum_plain(pk, pv, kv)
    b, s, h, d = pk.shape
    dk = torch.empty((b, s, kv, d), dtype=torch.bfloat16, device=pk.device)
    dv = torch.empty_like(dk)
    if pk.is_meta:
        meta.launch("flash_bwd_dkv_sum", costs.flash_dkv_sum_cost(b, s, h, kv, d))
        return dk, dv
    with torch.cuda.device(pk.device):
        lib = _sm90_lib()
        err = lib.flash_gqa_sm90_dkv_sum(pk.data_ptr(), pv.data_ptr(), dk.data_ptr(),
                                         dv.data_ptr(), b, s, h, kv, d,
                                         torch.cuda.current_stream().cuda_stream)
        check_launch(lib, err, "flash_gqa_sm90_dkv_sum", "flash_gqa_sm90")
    LAUNCHES["flash_bwd_dkv_sum"] += 1
    return dk, dv


def row_delta(dout, out):
    """delta = rowsum(dO * O) in f32, (B, S, H, D) -> (B, H, S)."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


class _FlashGQA(torch.autograd.Function):
    """Forward: K5 (out and the LSE residual).  Backward: K6 + K7."""

    @staticmethod
    def forward(q, k, v, window, softcap, scale, q0):
        return flash_fwd(q, k, v, window, softcap, scale, q0)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, window, softcap, scale, q0 = inputs
        out, lse = output
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (window, softcap, scale)
        ctx.offset = bool(q0) or q.shape[1] != k.shape[1]

    @staticmethod
    def backward(ctx, dout, _dlse):
        if ctx.offset:
            raise NotImplementedError(
                "a backward through K5 at a query offset: K6 and K7 take no offset, and "
                "repro has no sequence-parallel backward that lowers (ROADMAP.md section 3, "
                "R7)")
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        delta = row_delta(dout, out)
        with kernel_scope("flash_gqa_bwd", "kernel" if q.is_cuda else "auto"):
            dq = flash_bwd_dq(q, k, v, dout, lse, delta, *ctx.args)
            dk, dv = flash_bwd_dkv(q, k, v, dout, lse, delta, *ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_gqa(q, k, v, window=None, softcap=None, scale=None, impl: str = "auto", q0=None):
    """q: (B,Sq,H,D), k/v: (B,S,KV,D) -> (B,Sq,H,D).  Causal GQA attention,
    differentiable in q, k and v; the queries at positions q0 .. q0 + Sq -
    1 of the S keys (``q0`` None: Sq = S; no backward with an offset)."""
    if check_impl(impl, "flash_gqa", q) == "reference":
        return flash_gqa_ref(q, k, v, window, softcap, scale, q0)
    out, _ = _FlashGQA.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                             window, softcap, scale, q0)
    return out
