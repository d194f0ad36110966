"""Public wrappers: fused RMSNorm (K4).

``rmsnorm(x, scale, eps, impl)`` takes any leading dims, as
``repro.kernels.rmsnorm.ops.rmsnorm`` does.  Its forward is

  ``rmsnorm_fwd``  K4: one launch of ``csrc/rmsnorm.cu`` for a CUDA tensor,
                   the plain version (``rmsnorm_plain``) for a CPU tensor;

and its backward is autograd of the oracle (``ref.rmsnorm_ref``) on the
saved inputs, as ``repro``'s VJP of its oracle: there is no backward
kernel.  ``impl`` follows ``repro_torch.kernels.dispatch``: "auto" and
"kernel" go through ``rmsnorm_fwd`` ("kernel" refuses CPU tensors),
"reference" runs the oracle with plain autograd.  ``LAUNCHES`` counts
kernel launches (never plain calls).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels.build import bind, check_launch
from repro_torch.kernels.dispatch import check_impl
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

SOURCE = Path(__file__).parent / "csrc" / "rmsnorm.cu"
LAUNCHES = {"rmsnorm": 0}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_PTR, _I64, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
SIGNATURES = {
    "rmsnorm_fwd": ([_PTR, _PTR, _INT, _I64, _INT, ctypes.c_float, _PTR, _PTR], _INT),
    "rmsnorm_error_string": ([_INT], ctypes.c_char_p),
}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind(SOURCE, SIGNATURES)


def build() -> None:
    """Compile (or load the cached) kernel library now."""
    _lib()


# The kernel's plain version is the oracle itself: same f32 ops, same order.
rmsnorm_plain = rmsnorm_ref


def rmsnorm_fwd(x, scale, eps: float = 1e-6):
    """K4 on the card for a CUDA tensor; the plain version for a CPU one.
    x: contiguous (rows, D); scale: (D,) of x's dtype."""
    if x.dim() != 2 or scale.shape != (x.shape[1],):
        raise ValueError(f"need x (rows, D) and scale (D,), got {tuple(x.shape)} "
                         f"and {tuple(scale.shape)}")
    if x.dtype not in _DTYPE_CODES or scale.dtype != x.dtype:
        raise ValueError(f"x and scale must both be float32 or bfloat16, got "
                         f"{x.dtype} and {scale.dtype}")
    if scale.device != x.device:
        raise ValueError(f"x on {x.device}, scale on {scale.device}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("x and scale must be contiguous")
    if not x.is_cuda:
        return rmsnorm_plain(x, scale, eps)
    y = torch.empty_like(x)
    rows, d = x.shape
    if rows == 0:
        return y
    with torch.cuda.device(x.device):
        err = _lib().rmsnorm_fwd(x.data_ptr(), scale.data_ptr(), _DTYPE_CODES[x.dtype],
                                 rows, d, eps, y.data_ptr(),
                                 torch.cuda.current_stream().cuda_stream)
    check_launch(_lib(), err, "rmsnorm_fwd", "rmsnorm")
    LAUNCHES["rmsnorm"] += 1
    return y


class _RMSNorm(torch.autograd.Function):
    """Forward: K4.  Backward: autograd of the oracle on the saved inputs."""

    @staticmethod
    def forward(x, scale, eps):
        d = x.shape[-1]
        return rmsnorm_fwd(x.reshape(-1, d), scale, eps).reshape(x.shape)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, scale, eps = inputs
        ctx.save_for_backward(x, scale)
        ctx.eps = eps

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        with torch.enable_grad():
            xx = x.detach().requires_grad_()
            ss = scale.detach().requires_grad_()
            gx, gs = torch.autograd.grad(rmsnorm_ref(xx, ss, ctx.eps), (xx, ss), g)
        return gx, gs, None


def rmsnorm(x, scale, eps: float = 1e-6, impl: str = "auto"):
    """x: (..., D); scale: (D,).  Differentiable in both."""
    if check_impl(impl, "rmsnorm", x) == "reference":
        return rmsnorm_ref(x, scale, eps)
    return _RMSNorm.apply(x.contiguous(), scale.contiguous(), eps)
