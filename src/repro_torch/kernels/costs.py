"""The work of each CUDA kernel of the port, and the H100's rates for it.

Each ``*_cost`` function gives one launch's ``{"flops", "bytes", "peak"}``:
the bytes it must move (each input read once, each output written once),
the operations it must do, and the rate its operations run at.  Flash
attention counts the visible (query, key) pairs only; its bf16 launches
run at the bf16 tensor-core peak and its f32 launches at a third of the
TF32 peak (``flash_peak``).  ``bound_ms`` turns a
cost into the least time the card could take for it.

The kernels' meta-device path (``kernels/meta.py``, the dry run's census)
records these costs; ``launch/roofline.py`` re-exports them beside the
step-level roofline terms, and ``chip_smoke.py``'s bounds read them from
there, so the card's bounds and the dry run count the same work.
"""
from __future__ import annotations

from repro_torch.kernels.flash_gqa.grid import attention_pairs

PEAK_FLOPS = 989e12  # dense bf16 FLOP/s on the tensor cores, H100 SXM
TF32_FLOPS = 495e12  # dense TF32 FLOP/s on the tensor cores, H100 SXM
F32_FLOPS = 67e12  # f32 FLOP/s outside the tensor cores, H100 SXM
HBM_BW = 3.35e12  # B/s, H100 SXM HBM3


def _cost(flops, nbytes, peak):
    return {"flops": float(flops), "bytes": float(nbytes), "peak": peak}


def bound_ms(cost: dict):
    """(the least time the card could take for ``cost`` in ms, "bytes" or
    "operations"): the larger of bytes over HBM_BW and FLOPs over the peak."""
    t_bytes, t_ops = cost["bytes"] / HBM_BW, cost["flops"] / cost["peak"]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def reduce3_cost(c: int, n: int, tiles: int, itemsize: int, shared: bool = True) -> dict:
    """K1 over (C, N) rows: reads d_i and d_g (shared (N,) or (C, N)), writes
    (C, tiles, 3) f32 partials; 6 FLOPs an element, f32."""
    dg = n if shared else c * n
    return _cost(6 * c * n, c * n * itemsize + dg * itemsize + c * tiles * 12, F32_FLOPS)


def update_cost(c: int, n: int, itemsize: int, shared: bool = True) -> dict:
    """K2 over (C, N) rows: reads x, d_i, d_g and (beta, eta*coeff) per row,
    writes x'; 5 FLOPs an element, f32."""
    dg = n if shared else c * n
    return _cost(5 * c * n, 3 * c * n * itemsize + dg * itemsize + 8 * c, F32_FLOPS)


def rmsnorm_cost(rows: int, d: int, itemsize: int) -> dict:
    """K4 over (rows, D): reads x and the scale, writes y; 4 FLOPs an element."""
    return _cost(4 * rows * d, 2 * rows * d * itemsize + d * itemsize, PEAK_FLOPS)


def flash_peak(itemsize: int) -> float:
    """The rate of a flash launch's products: bf16 (``itemsize`` 2) at the
    bf16 peak; f32 at a third of the TF32 peak, since an f32-accurate
    product on the tensor cores takes three TF32 products (hi*hi, hi*lo,
    lo*hi of each operand split into two TF32 halves)."""
    return PEAK_FLOPS if itemsize == 2 else TF32_FLOPS / 3


def _flash_io(b, s, h, kv, d, itemsize):
    """(bytes of q + k + v, of one (B, S, H, D) tensor, of one (B, H, S) f32
    row vector)."""
    return (b * s * h * d + 2 * b * s * kv * d) * itemsize, b * s * h * d * itemsize, b * h * s * 4


def flash_fwd_cost(b, s, h, kv, d, window, itemsize, q0=0, sq=None) -> dict:
    """K5: reads q, k, v; writes out and the LSE; 4D FLOPs a visible pair.
    With a query offset: ``sq`` queries (None: S - q0) at positions q0 ..
    q0 + sq - 1 of the S keys, their q, out and LSE rows and their pairs,
    and the k and v rows they can see: keys max(0, q0 - window + 1) ..
    q0 + sq - 1 (at q0 = 0 all S keys)."""
    sq = s - q0 if sq is None else sq
    keys = min(s, q0 + sq) - (max(0, q0 - window + 1) if window else 0)
    io = (b * sq * h * d + 2 * b * keys * kv * d) * itemsize
    qsize, rows = b * sq * h * d * itemsize, b * h * sq * 4
    return _cost(4 * d * b * h * attention_pairs(s, window, q0, sq), io + qsize + rows,
                 flash_peak(itemsize))


def flash_dq_cost(b, s, h, kv, d, window, itemsize) -> dict:
    """K6: reads q, k, v, dO, LSE and delta; writes dq; 6D FLOPs a pair."""
    io, qsize, rows = _flash_io(b, s, h, kv, d, itemsize)
    return _cost(6 * d * b * h * attention_pairs(s, window), io + 2 * qsize + 2 * rows,
                 flash_peak(itemsize))


def flash_dkv_cost(b, s, h, kv, d, window, itemsize) -> dict:
    """K7: reads q, k, v, dO, LSE and delta; writes dk and dv; 8D FLOPs a
    pair."""
    io, qsize, rows = _flash_io(b, s, h, kv, d, itemsize)
    kvsize = b * s * kv * d * itemsize
    return _cost(8 * d * b * h * attention_pairs(s, window),
                 io + qsize + 2 * rows + 2 * kvsize, flash_peak(itemsize))


def flash_dkv_sum_cost(b, s, h, kv, d) -> dict:
    """K7's sum pass: reads the f32 dk and dv partials (B, S, H, D), writes
    bf16 dk and dv (B, S, KV, D); G - 1 adds an output element, f32."""
    out = b * s * kv * d
    return _cost(2 * (h // kv - 1) * out, 2 * b * s * h * d * 4 + 2 * out * 2, F32_FLOPS)
