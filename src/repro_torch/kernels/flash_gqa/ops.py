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
slice's type) runs K5-K7 on the tensor cores (``csrc/flash_gqa_sm90.cu``;
at G = H / KV > 1, K7 writes per-head f32 partials and
``flash_bwd_dkv_sum`` adds them in head order); f32 runs the SIMT kernels
of ``csrc/flash_gqa.cu``, whose products stay in f32.  A failed build or
launch raises.  The bf16 kernels round P, dS (K6) and P^T, dS^T (K7) to
bf16 for the tensor cores; ``flash_bwd_dq_wide`` and
``flash_bwd_dkv_partials`` return their f32 sums before the final
rounding, so ``chip_smoke.py`` can hold that departure to a bound.

``flash_gqa(q, k, v, window, softcap, scale, impl)`` is the
differentiable entry: an ``autograd.Function`` whose forward is K5 and
whose backward is K6 + K7, with delta a torch op between them as
``repro`` computes it outside its kernels.  "reference" runs the oracle
(``ref.flash_gqa_ref``) under plain autograd.  ``LAUNCHES`` counts kernel
launches (never plain calls); the K7 sum pass has its own key.

The kernels take the canonical positions arange(S): key j is visible to
query i iff j <= i and i - j < window.  Masked scores are NEG_INF in the
plain versions, as in ``repro``; the CUDA kernels keep them out of exp.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels.build import bind, check_launch
from repro_torch.kernels.dispatch import check_impl, kernel_scope
from repro_torch.kernels.flash_gqa.ref import NEG_INF, flash_gqa_ref, visible_mask

SOURCE = Path(__file__).parent / "csrc" / "flash_gqa.cu"
SM90_SOURCE = Path(__file__).parent / "csrc" / "flash_gqa_sm90.cu"
LAUNCHES = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0, "flash_bwd_dkv_sum": 0}
HEAD_DIMS = (64, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_PTR, _INT, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SHAPE = [_INT] * 7 + [_F32, _F32, _PTR]  # dtype b s h kv d window softcap scale stream
SIGNATURES = {
    "flash_gqa_fwd": ([_PTR] * 5 + _SHAPE, _INT),
    "flash_gqa_bwd_dq": ([_PTR] * 7 + _SHAPE, _INT),
    "flash_gqa_bwd_dkv": ([_PTR] * 8 + _SHAPE, _INT),
    "flash_gqa_error_string": ([_INT], ctypes.c_char_p),
}
SM90_SIGNATURES = {
    "flash_gqa_sm90_fwd": ([_PTR] * 5 + _SHAPE, _INT),
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


def _check(q, k, v, window, *rows, **more):
    """Validate what every kernel takes; returns (B, S, H, KV, D)."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"need q (B,S,H,D) and k/v (B,S,KV,D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    kv = k.shape[2]
    if k.shape[:2] != (b, s) or k.shape[3] != d or h % kv:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)} "
                         "(same B, S, D; H a multiple of KV)")
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
    if q.is_cuda and d not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernels take head_dim in {HEAD_DIMS}, got {d}")
    return b, s, h, kv, d


def _launch(kind, *args, dtype, b, s, h, kv, d, window, softcap, scale):
    """Launch ``flash_gqa_<kind>`` (bf16: ``flash_gqa_sm90_<kind>``) on
    ``args`` (the pointers, and the sm90 dq pass's output dtype) and count it
    under ``flash_<kind>``."""
    lib, prefix = ((_sm90_lib(), "flash_gqa_sm90") if dtype == torch.bfloat16
                   else (_lib(), "flash_gqa"))
    name = f"{prefix}_{kind}"
    err = getattr(lib, name)(*args, _DTYPE_CODES[dtype], b, s, h, kv, d,
                             window or 0, softcap or 0.0, scale,
                             torch.cuda.current_stream().cuda_stream)
    check_launch(lib, err, name, prefix)
    LAUNCHES[f"flash_{kind}"] += 1


# -- plain versions ----------------------------------------------------------


def _scores(q, k, window, softcap, scale):
    """Scaled, softcapped, masked f32 scores (B, KV, G, Sq, Sk), the raw
    tanh (for the softcap's chain factor, or None), and q*scale grouped as
    (B, S, KV, G, D)."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    qs = (q.float() * scale).reshape(b, s, kv, h // kv, d)
    sc = torch.einsum("bqkgd,btkd->bkgqt", qs, k.float())
    t = None
    if softcap is not None:
        t = torch.tanh(sc / softcap)
        sc = softcap * t
    sc = sc.masked_fill(~visible_mask(s, window, q.device), NEG_INF)
    return sc, t, qs


def flash_fwd_plain(q, k, v, window=None, softcap=None, scale=None):
    """Plain K5: (out (B,S,H,D) in q's dtype, lse (B,H,S) f32)."""
    b, s, h, d = q.shape
    sc, _, _ = _scores(q, k, window, softcap, _scale(d, scale))
    lse = torch.logsumexp(sc, dim=-1)
    p = torch.exp(sc - lse[..., None])
    out = torch.einsum("bkgqt,btkd->bqkgd", p, v.float()).reshape(b, s, h, d)
    return out.to(q.dtype), lse.reshape(b, h, s)


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


def flash_fwd(q, k, v, window=None, softcap=None, scale=None):
    """K5 on the card for CUDA tensors; the plain version for CPU ones."""
    b, s, h, kv, d = _check(q, k, v, window)
    if not q.is_cuda:
        return flash_fwd_plain(q, k, v, window, softcap, scale)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _launch("fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out.data_ptr(), lse.data_ptr(), dtype=q.dtype, b=b, s=s, h=h, kv=kv,
                d=d, window=window, softcap=softcap, scale=_scale(d, scale))
    return out, lse


def _dq(q, k, v, dout, lse, delta, window, softcap, scale, dq_dtype):
    """Launch K6 into a new dq of ``dq_dtype`` (the bf16 kernel takes that
    dtype as an argument; the f32 one writes f32)."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    dq = torch.empty(q.shape, dtype=dq_dtype, device=q.device)
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr()]
    if q.dtype == torch.bfloat16:
        args.append(_DTYPE_CODES[dq_dtype])
    with torch.cuda.device(q.device):
        _launch("bwd_dq", *args, dtype=q.dtype, b=b, s=s, h=h, kv=kv, d=d, window=window,
                softcap=softcap, scale=_scale(d, scale))
    return dq


def flash_bwd_dq(q, k, v, dout, lse, delta, window=None, softcap=None, scale=None):
    """K6 on the card for CUDA tensors; the plain version for CPU ones."""
    _check(q, k, v, window, lse, delta, dout=dout)
    if not q.is_cuda:
        return flash_bwd_dq_plain(q, k, v, dout, lse, delta, window, softcap, scale)
    return _dq(q, k, v, dout, lse, delta, window, softcap, scale, q.dtype)


def flash_bwd_dq_wide(q, k, v, dout, lse, delta, window=None, softcap=None, scale=None):
    """bf16 K6 on the card before its final rounding: dq (B,S,H,D) in f32."""
    _check(q, k, v, window, lse, delta, dout=dout)
    if not (q.is_cuda and q.dtype == torch.bfloat16):
        raise ValueError(f"the wide dq comes from bf16 CUDA tensors, got {q.dtype} on "
                         f"{q.device}")
    return _dq(q, k, v, dout, lse, delta, window, softcap, scale, torch.float32)


def flash_bwd_dkv(q, k, v, dout, lse, delta, window=None, softcap=None, scale=None):
    """K7 on the card for CUDA tensors; the plain version for CPU ones."""
    b, s, h, kv, d = _check(q, k, v, window, lse, delta, dout=dout)
    if not q.is_cuda:
        return flash_bwd_dkv_plain(q, k, v, dout, lse, delta, window, softcap, scale)
    # bf16 at G > 1: the tensor-core kernel writes f32 per-query-head
    # partials, which the sum pass adds in head order (no atomics)
    if q.dtype == torch.bfloat16 and h > kv:
        return flash_bwd_dkv_sum(*flash_bwd_dkv_partials(q, k, v, dout, lse, delta, window,
                                                         softcap, scale), kv)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        _launch("bwd_dkv", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), dtype=q.dtype, b=b, s=s, h=h, kv=kv, d=d, window=window,
                softcap=softcap, scale=_scale(d, scale))
    return dk, dv


def flash_bwd_dkv_partials(q, k, v, dout, lse, delta, window=None, softcap=None, scale=None):
    """bf16 K7 at G > 1 on the card, before its sum pass: the f32 dk and dv
    partials of each query head, (B,S,H,D) each."""
    b, s, h, kv, d = _check(q, k, v, window, lse, delta, dout=dout)
    if not (q.is_cuda and q.dtype == torch.bfloat16 and h > kv):
        raise ValueError(f"per-head partials come from bf16 CUDA tensors with H > KV, got "
                         f"{q.dtype} on {q.device}, H={h} KV={kv}")
    dk = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _launch("bwd_dkv", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), dtype=q.dtype, b=b, s=s, h=h, kv=kv, d=d, window=window,
                softcap=softcap, scale=_scale(d, scale))
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
    if not pk.is_cuda:
        return flash_bwd_dkv_sum_plain(pk, pv, kv)
    b, s, h, d = pk.shape
    dk = torch.empty((b, s, kv, d), dtype=torch.bfloat16, device=pk.device)
    dv = torch.empty_like(dk)
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
    def forward(q, k, v, window, softcap, scale):
        return flash_fwd(q, k, v, window, softcap, scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, window, softcap, scale = inputs
        out, lse = output
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (window, softcap, scale)

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        delta = row_delta(dout, out)
        with kernel_scope("flash_gqa_bwd", "kernel" if q.is_cuda else "auto"):
            dq = flash_bwd_dq(q, k, v, dout, lse, delta, *ctx.args)
            dk, dv = flash_bwd_dkv(q, k, v, dout, lse, delta, *ctx.args)
        return dq, dk, dv, None, None, None


def flash_gqa(q, k, v, window=None, softcap=None, scale=None, impl: str = "auto"):
    """q: (B,S,H,D), k/v: (B,S,KV,D) -> (B,S,H,D).  Causal GQA attention,
    differentiable in q, k and v."""
    if check_impl(impl, "flash_gqa", q) == "reference":
        return flash_gqa_ref(q, k, v, window, softcap, scale)
    out, _ = _FlashGQA.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                             window, softcap, scale)
    return out
