"""Grid arithmetic of the flash_gqa kernels.

``_block_sizes``, ``_first_kv_block``, ``flash_gqa_grid`` and
``flash_gqa_bwd_grid`` are ``repro/kernels/flash_gqa/kernel.py:53-110``
as they are: the TPU kernels' window-pruned grids at their (512-default)
tiles, kept so the tile census the benchmarks quote can be checked
against ``repro``.  The CUDA kernels (``csrc/flash_gqa.cu``) use their
own tiles and compute the exact tile range a window needs themselves;
``sm90_fwd_key_tiles``, ``sm90_dq_key_tiles`` and ``sm90_dkv_query_tiles``
are those ranges of the tensor-core kernels (``csrc/flash_gqa_sm90.cu``),
written out so the CPU tests can hold them to the mask.  ``attention_pairs`` counts the
(query, key) pairs causality and the window leave, the work any
implementation must do (``chip_smoke.py``'s operation bounds).
"""
from __future__ import annotations


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _block_sizes(s: int, bq: int, bk: int):
    """Clamp/halve the requested block sizes until they divide S."""
    bq = min(bq, s)
    while s % bq:
        bq //= 2
    bk = min(bk, s)
    while s % bk:
        bk //= 2
    return bq, bk, s // bq, s // bk


def _first_kv_block(qi: int, bq: int, bk: int, nkp: int) -> int:
    """First visited k-block for q block ``qi`` under the pruned grid."""
    last = (qi * bq + bq - 1) // bk
    return max(last - (nkp - 1), 0)


def flash_gqa_grid(s: int, bq: int = 512, bk: int = 512, window=None,
                   prune_window: bool = True):
    """(nq, nk_visited) of the TPU forward for the given sequence/window/tiling."""
    bq, bk, nq, nk = _block_sizes(s, bq, bk)
    if window is None or not prune_window:
        return nq, nk
    return nq, min(nk, _cdiv(window + bq, bk) + 1)


def flash_gqa_bwd_grid(s: int, bq: int = 512, bk: int = 512, window=None,
                       prune_window: bool = True):
    """Visited block counts of the TPU backward passes: (nk_dq, nq_dkv)."""
    bq, bk, nq, nk = _block_sizes(s, bq, bk)
    _, nkp = flash_gqa_grid(s, bq, bk, window, prune_window)
    if window is not None and prune_window:
        nqv = min(nq, _cdiv(window + bk, bq) + 1)
    else:
        nqv = nq
    return nkp, nqv


def attention_pairs(s: int, window=None) -> int:
    """(query, key) pairs with k <= q and q - k < window, per (batch, head)."""
    if window is None or window >= s:
        return s * (s + 1) // 2
    w = window
    return w * (w + 1) // 2 + (s - w) * w


SM90_TILE = 64       # keys of a K5 K/V tile; keys and queries of a K7 tile
SM90_FWD_ROWS = 128  # query rows of a K5 or K6 block (two warpgroups of 64)
SM90_DQ_KEYS = 32    # keys of a K6 K/V tile


def _key_tiles(q0: int, rows: int, s: int, window, keys: int) -> range:
    if q0 >= s:
        return range(0)
    first = max(0, q0 - window + 1) // keys if window else 0
    last = (min(q0 + rows, s) - 1) // keys
    return range(first, last + 1)


def sm90_fwd_key_tiles(q0: int, rows: int, s: int, window=None) -> range:
    """Key tiles (of 64 keys) that query rows q0 .. q0 + rows - 1 visit in
    ``fwd_kernel``: a block's range at rows = 128, one warpgroup's (the
    tiles it computes) at rows = 64.  Rows that all lie past S visit none."""
    return _key_tiles(q0, rows, s, window, SM90_TILE)


def sm90_dq_key_tiles(q0: int, rows: int, s: int, window=None) -> range:
    """Key tiles (of 32 keys) that query rows q0 .. q0 + rows - 1 visit in
    ``dq_kernel``, as ``sm90_fwd_key_tiles`` for ``fwd_kernel``."""
    return _key_tiles(q0, rows, s, window, SM90_DQ_KEYS)


def sm90_dkv_query_tiles(kt: int, s: int, window=None) -> range:
    """Query tiles (of 64 queries) that key tile ``kt`` visits in
    ``dkv_kernel``."""
    k0 = kt * SM90_TILE
    k1 = min(k0 + SM90_TILE, s) - 1
    last = min(s - 1, k1 + window - 1) if window else s - 1
    return range(k0 // SM90_TILE, last // SM90_TILE + 1)
