"""Public wrappers: fused pFedSOP round-start update (K1 reduce, K2 update).

``pfedsop_update_batched(x, delta_i, delta_g, ...)`` takes a cohort of
flat parameter rows ``x``/``delta_i`` ``(C, N)`` and the server delta
``delta_g``, shared as ``(N,)`` or per client as ``(C, N)``, and returns
``(x_new (C, N), beta (C,))``.  It is two launches on the card:

  ``reduce3_batched``  K1: per (client, tile) f32 partials of
                       <d_i, d_g>, |d_i|^2, |d_g|^2 -> (C, T, 3);
  (torch, on device)   tile sum, Gompertz beta, Sherman-Morrison
                       coefficient (no host sync);
  ``update_batched``   K2: x - eta1*coeff*((1-beta) d_i + beta d_g).

``pfedsop_update`` is the one-client (C = 1) case.  Each wrapper launches
its CUDA kernel (``csrc/pfedsop_update.cu``) for a CUDA tensor and runs
its plain PyTorch version (``*_plain``) for a CPU tensor; there is no
other fallback.  ``LAUNCHES`` counts kernel launches (never plain calls).

Operands are used in place: no flatten, pad or copy.  The tile count T
depends on N alone (``n_tiles``), so the partials, and the sums made
from them, do not depend on timing.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch.kernels.build import bind, check_launch
from repro_torch.kernels.dispatch import check_impl
from repro_torch.kernels.pfedsop_update.ref import (
    coeff_from_sums,
    gompertz_beta,
    pfedsop_update_batched_ref,
)

SOURCE = Path(__file__).parent / "csrc" / "pfedsop_update.cu"
TILE = 4096  # elements of one client row per block, both kernels
LAUNCHES = {"reduce3": 0, "update": 0}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


_PTR, _I64, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# the C interface of csrc/pfedsop_update.cu: (argtypes, restype) per symbol;
# every pointer and the stream as c_void_p, or ctypes would cut them to 32 bits
SIGNATURES = {
    "pfedsop_reduce3": ([_PTR, _PTR, _INT, _I64, _I64, _I64, _I64, _I64, _PTR, _PTR],
                        _INT),
    "pfedsop_update": ([_PTR, _PTR, _PTR, _INT, _I64, _I64, _I64, _I64, _PTR, _PTR,
                        _PTR, _PTR], _INT),
    "pfedsop_error_string": ([_INT], ctypes.c_char_p),
}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind(SOURCE, SIGNATURES)


def build() -> None:
    """Compile (or load the cached) kernel library now."""
    _lib()


def n_tiles(n: int) -> int:
    return -(-n // TILE)


def _check_launch(err: int, name: str) -> None:
    check_launch(_lib(), err, name, "pfedsop")


def _operands(delta_i, delta_g, *more):
    """Validate the operands every kernel of the pair takes; returns
    (C, N, d_g row stride in elements: 0 when shared)."""
    if delta_i.dim() != 2:
        raise ValueError(f"delta_i must be (C, N), got {tuple(delta_i.shape)}")
    c, n = delta_i.shape
    if c == 0 or n == 0 or c > 65535:
        raise ValueError(f"need 1 <= C <= 65535 and N >= 1, got ({c}, {n})")
    if tuple(delta_g.shape) not in ((n,), (c, n)):
        raise ValueError(f"delta_g must be ({n},) or ({c}, {n}), got "
                         f"{tuple(delta_g.shape)}")
    for t in (delta_i, delta_g) + more:
        if t.dtype not in _DTYPE_CODES or t.dtype != delta_i.dtype:
            raise ValueError(f"operands must all be float32 or all bfloat16, "
                             f"got {t.dtype} beside {delta_i.dtype}")
        if t.device != delta_i.device:
            raise ValueError(f"operands on {t.device} and {delta_i.device}")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    return c, n, (n if delta_g.dim() == 2 else 0)


def _scalars(c, device, *vals):
    for v in vals:
        if v.shape != (c,) or v.dtype != torch.float32 or v.device != device \
                or not v.is_contiguous():
            raise ValueError(f"per-client scalars must be contiguous ({c},) "
                             f"float32 on {device}, got {tuple(v.shape)} "
                             f"{v.dtype} on {v.device}")


# -- K1 ---------------------------------------------------------------------


def reduce3_batched_plain(delta_i, delta_g):
    """Plain PyTorch K1: the same (C, T, 3) f32 tile partials."""
    c, n = delta_i.shape
    t = n_tiles(n)
    pad = (0, t * TILE - n)
    a = F.pad(delta_i.float(), pad).view(c, t, TILE)
    g = F.pad(delta_g.float(), pad).view(-1, t, TILE)
    return torch.stack([(a * g).sum(-1), (a * a).sum(-1),
                        (g * g).sum(-1).expand(c, t)], dim=-1)


def reduce3_batched(delta_i, delta_g):
    """K1 on the card for CUDA tensors; the plain version for CPU ones."""
    c, n, dg_stride = _operands(delta_i, delta_g)
    if not delta_i.is_cuda:
        return reduce3_batched_plain(delta_i, delta_g)
    tiles = n_tiles(n)
    partials = torch.empty((c, tiles, 3), dtype=torch.float32,
                           device=delta_i.device)
    with torch.cuda.device(delta_i.device):
        err = _lib().pfedsop_reduce3(
            delta_i.data_ptr(), delta_g.data_ptr(), _DTYPE_CODES[delta_i.dtype],
            c, n, dg_stride, TILE, tiles, partials.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _check_launch(err, "pfedsop_reduce3")
    LAUNCHES["reduce3"] += 1
    return partials


# -- K2 ---------------------------------------------------------------------


def update_batched_plain(x, delta_i, delta_g, beta, eta_coeff):
    """Plain PyTorch K2, in the kernel's order of rounded operations."""
    b = beta[:, None]
    dp = (1.0 - b) * delta_i.float() + b * delta_g.float()
    return (x.float() - eta_coeff[:, None] * dp).to(x.dtype)


def update_batched(x, delta_i, delta_g, beta, eta_coeff):
    """K2 on the card for CUDA tensors; the plain version for CPU ones.
    ``beta``/``eta_coeff``: (C,) f32 on the operands' device."""
    c, n, dg_stride = _operands(delta_i, delta_g, x)
    if x.shape != delta_i.shape:
        raise ValueError(f"x {tuple(x.shape)} != delta_i {tuple(delta_i.shape)}")
    _scalars(c, x.device, beta, eta_coeff)
    if not x.is_cuda:
        return update_batched_plain(x, delta_i, delta_g, beta, eta_coeff)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _lib().pfedsop_update(
            x.data_ptr(), delta_i.data_ptr(), delta_g.data_ptr(),
            _DTYPE_CODES[x.dtype], c, n, dg_stride, TILE, beta.data_ptr(),
            eta_coeff.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _check_launch(err, "pfedsop_update")
    LAUNCHES["update"] += 1
    return out


# -- the fused update -------------------------------------------------------


def pfedsop_update_batched(x, delta_i, delta_g, eta1=0.01, rho=1.0, lam=1.0,
                           eps=1e-12, impl: str = "auto"):
    """Fused update over a leading client axis (see module docstring).

    ``impl``: "auto"/"kernel" run K1 + K2 through the wrappers above
    ("kernel" refuses CPU tensors); "reference" runs the oracle in
    ``ref.py``.  Returns (x_new (C, N) in x's dtype, beta (C,) f32)."""
    if check_impl(impl, "pfedsop_update", x) == "reference":
        return pfedsop_update_batched_ref(x, delta_i, delta_g, eta1, rho, lam, eps)
    partials = reduce3_batched(delta_i, delta_g)
    dot, nl2, ng2 = partials.sum(dim=1).unbind(-1)
    beta = gompertz_beta(dot, nl2, ng2, lam, eps).contiguous()
    eta_coeff = (eta1 * coeff_from_sums(dot, nl2, ng2, beta, rho)).contiguous()
    return update_batched(x, delta_i, delta_g, beta, eta_coeff), beta


def pfedsop_update(x, delta_i, delta_g, eta1=0.01, rho=1.0, lam=1.0,
                   eps=1e-12, impl: str = "auto"):
    """One client, flat (N,) vectors: the C = 1 launch of the pair.
    Returns (x_new (N,), beta scalar f32)."""
    out, beta = pfedsop_update_batched(x[None], delta_i[None], delta_g, eta1,
                                       rho, lam, eps, impl)
    return out[0], beta[0]
