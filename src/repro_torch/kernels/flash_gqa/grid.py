"""Grid arithmetic of the flash_gqa kernels.

``_block_sizes``, ``_first_kv_block``, ``flash_gqa_grid`` and
``flash_gqa_bwd_grid`` are ``repro/kernels/flash_gqa/kernel.py:53-110``
as they are: the TPU kernels' window-pruned grids at their (512-default)
tiles, kept so the tile census the benchmarks quote can be checked
against ``repro``.  The CUDA kernels (``csrc/flash_gqa.cu``) use their
own tiles and compute the exact tile range a window needs themselves (K5
on absolute positions, at a query offset too); ``sm90_fwd_key_tiles``,
``sm90_dq_key_tiles`` and ``sm90_dkv_query_tiles`` are those ranges of the
tensor-core kernels (``csrc/flash_gqa_sm90.cu``), at head_dim 256 and at 64,
80 and 128 (the narrow kernels there: K5's and K6's 128-key tiles, K7's
128-key blocks of two warpgroups' 64 keys), written out so the CPU tests can
hold them to the mask; ``tf32_fwd_key_tiles``, ``tf32_dq_key_tiles``,
``tf32_dkv_query_tiles`` and the ``*_warp_sees`` tests are the same of the
f32 mma.sync kernels of ``csrc/flash_gqa.cu`` (``fwd_tf32_kernel``: D = 64,
80 and 128, at a query offset too; ``dq_tf32_kernel``, ``dkv_tf32_kernel``:
D = 80 and 128), ``wgmma_dq_key_tiles`` and ``wgmma_dkv_query_tiles`` of
its wgmma kernels (``dq_wgmma_kernel``, ``dkv_wgmma_kernel``: D = 64).
``attention_pairs`` counts the (query, key) pairs causality and the window
leave, the work any implementation must do (``chip_smoke.py``'s operation
bounds), of every query row or of a rank's rows q0 .. q0 + sq - 1.
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


def attention_pairs(s: int, window=None, q0: int = 0, sq=None) -> int:
    """(query, key) pairs with k <= q and q - k < window, per (batch, head),
    of the query rows q0 .. q0 + sq - 1 (``sq`` None: S - q0; a rank of a
    sequence-parallel prefill)."""
    sq = s - q0 if sq is None else sq
    if q0:  # the pairs of rows 0 .. q0 + sq - 1 less those of rows 0 .. q0 - 1
        return attention_pairs(q0 + sq, window) - attention_pairs(q0, window)
    s = sq
    if window is None or window >= s:
        return s * (s + 1) // 2
    w = window
    return w * (w + 1) // 2 + (s - w) * w


SM90_TILE = 64  # keys of a K5 K/V tile (D = 256); keys and queries of a K7 tile
SM90_FWD_ROWS = 128  # query rows of a K5 or K6 block (two warpgroups of 64)
SM90_DQ_KEYS = 32    # keys of a K6 K/V tile (D = 256)
# at head_dim 64, 80 and 128 (fwd_narrow_kernel, dq_narrow_kernel, dkv_narrow_kernel)
SM90_FWD_NARROW_KEYS = 128  # keys of a K5 K/V tile
SM90_DQ_NARROW_KEYS = 128   # keys of a K6 K/V tile
SM90_DKV_NARROW_KEYS = 128  # keys of a K7 block: 64 a warpgroup, a K7 query tile still 64


def _key_tiles(q0: int, rows: int, s: int, window, keys: int) -> range:
    """Key tiles of rows at absolute positions q0 .. q0 + rows - 1, rows at
    or past ``s`` (one past the last query) seeing nothing."""
    if q0 >= s:
        return range(0)
    first = max(0, q0 - window + 1) // keys if window else 0
    last = (min(q0 + rows, s) - 1) // keys
    return range(first, last + 1)


def sm90_fwd_key_tiles(r0: int, rows: int, s: int, window=None, q0: int = 0,
                       sq=None, keys: int = SM90_TILE) -> range:
    """Key tiles (of ``keys`` keys: 64 in ``fwd_kernel``, 128 at head_dim
    64, 80 and 128 in ``fwd_narrow_kernel``) that query rows r0 .. r0 +
    rows - 1 visit: a block's range at rows = 128, one warpgroup's (the tiles it
    computes) at rows = 64.  Rows are the launch's, whose query 0 sits at
    position ``q0`` of the S keys and which holds ``sq`` queries (None:
    S - q0); rows that all lie past the last query visit none."""
    sq = s - q0 if sq is None else sq
    return _key_tiles(q0 + r0, rows, q0 + sq, window, keys)


def sm90_dq_key_tiles(q0: int, rows: int, s: int, window=None,
                      keys: int = SM90_DQ_KEYS) -> range:
    """Key tiles (of ``keys`` keys: 32, or 128 at head_dim 64, 80 and 128)
    that query rows q0 .. q0 + rows - 1 visit in ``dq_kernel``
    (``dq_narrow_kernel``), as ``sm90_fwd_key_tiles`` for ``fwd_kernel``."""
    return _key_tiles(q0, rows, s, window, keys)


def sm90_dkv_query_tiles(kt: int, s: int, window=None, keys: int = SM90_TILE) -> range:
    """Query tiles (of 64 queries) that key block ``kt`` of ``keys`` keys
    visits in ``dkv_kernel`` (64), or at head_dim 64, 80 and 128 in
    ``dkv_narrow_kernel``: a block at 128, each of its warpgroups (64-key
    tile 2 kt + w) at 64.  Keys that all lie past S visit none."""
    k0 = kt * keys
    k1 = min(k0 + keys, s) - 1
    last = min(s - 1, k1 + window - 1) if window else s - 1
    return range(k0 // SM90_TILE, last // SM90_TILE + 1)


def sm90_fwd_narrow_blocks(b: int, h: int, n_qt: int, sms: int) -> list:
    """The work of ``fwd_narrow_kernel``'s persistent blocks (K5 at head_dim
    64, 80 and 128): one list a block of its (batch*head, query tile) items,
    in the order it runs them, for ``n_qt`` 128-row query tiles and ``sms``
    SMs.  Heads go in groups of hg = sms // n_qt and the launch takes
    hg * n_qt blocks (at most one an item); where n_qt > sms, ``sms``
    blocks and one group of all heads.  The list holds each group's items
    heaviest (last) query tile first; round k gives item k*P + c to block
    c, or k*P + P-1-c on odd rounds."""
    bhs = b * h
    items = bhs * n_qt
    hg = min(bhs, sms // n_qt) if n_qt <= sms else bhs
    p = min(items, hg * n_qt if n_qt <= sms else sms)
    hg = min(bhs, p // n_qt) if p >= n_qt else bhs  # as the kernel has it, from its blocks

    def item(w):
        group = w // (hg * n_qt)
        in_group = min(hg, bhs - group * hg)
        r = w - group * hg * n_qt
        return group * hg + r % in_group, n_qt - 1 - r // in_group

    blocks = [[] for _ in range(p)]
    for k in range(_cdiv(items, p)):
        for c in range(p):
            w = k * p + (p - 1 - c if k & 1 else c)
            if w < items:
                blocks[c].append(item(w))
    return blocks


TF32_DQ_ROWS = 128   # query rows of an f32 K5 or K6 block (fwd_ and dq_tf32_kernel), 16 a warp
TF32_WARP_ROWS = 16  # rows of one warp (K5, K6 queries; K7 keys, at D = 128 of a pair of warps)


def tf32_dq_tile(d: int) -> int:
    """f32 K6's (and K5's) key tile at head_dim ``d``."""
    return 32 if d == 128 else 64


def tf32_dkv_keys(d: int) -> int:
    """f32 K7's keys a block at head_dim ``d``: 64 at 128, where two warps
    share 16 keys, else 128."""
    return 64 if d == 128 else 128


TF32_DKV_TILE = 32  # queries of an f32 mma.sync K7 tile (dkv_tf32_kernel)


def tf32_dq_key_tiles(q0: int, s: int, d: int, window=None) -> range:
    """The key tiles dq_tf32_kernel visits for its block of queries q0 ..
    q0 + 127: every tile with a key the block can see."""
    bk = tf32_dq_tile(d)
    first = max(0, q0 - window + 1) // bk if window else 0
    return range(first, (min(q0 + TF32_DQ_ROWS, s) - 1) // bk + 1)


def tf32_fwd_key_tiles(r0: int, s: int, d: int, window=None, q0: int = 0, sq=None) -> range:
    """The key tiles fwd_tf32_kernel (K5: K6's blocks and key tiles, on
    absolute positions) visits for its block of the launch's rows r0 .. r0
    + 127, whose query 0 sits at position ``q0`` of the S keys and which
    holds ``sq`` queries (None: S - q0); its warps skip tiles by
    ``tf32_dq_warp_sees`` with ``s`` one past its last query."""
    sq = s - q0 if sq is None else sq
    return tf32_dq_key_tiles(q0 + r0, q0 + sq, d, window)


def tf32_dq_warp_sees(qw: int, k0: int, s: int, d: int, window=None) -> bool:
    """Whether the warp of queries qw .. qw + 15 multiplies the key tile at
    k0 (it skips a tile where none of its rows sees a key; ``s``: one past
    the last query)."""
    return (qw < s and k0 <= qw + TF32_WARP_ROWS - 1
            and (not window or k0 + tf32_dq_tile(d) - 1 >= qw - window + 1))


def tf32_dkv_query_tiles(k0: int, s: int, d: int, window=None) -> range:
    """The query tiles (of each of the G heads) dkv_tf32_kernel visits for
    its block of keys k0 .. k0 + ``tf32_dkv_keys(d)`` - 1: every tile with a
    query that sees one of them."""
    bq = TF32_DKV_TILE
    k1 = min(k0 + tf32_dkv_keys(d), s) - 1
    return range(k0 // bq, (min(s - 1, k1 + window - 1) if window else s - 1) // bq + 1)


def tf32_dkv_warp_sees(kw: int, q0: int, s: int, d: int, window=None) -> bool:
    """Whether the warp (at D = 128 the pair of warps) of keys kw .. kw + 15
    multiplies the query tile at q0 (it skips a tile where no query sees
    one of its keys)."""
    return (kw < s and q0 < s and q0 + TF32_DKV_TILE - 1 >= kw
            and (not window or q0 <= kw + TF32_WARP_ROWS - 1 + window - 1))


WGMMA_BLOCK = 64  # queries of an f32 wgmma K6 block, keys of a K7 block: wgmma's M
WGMMA_TILE = 32   # keys of a streamed K6 tile, queries of a K7 tile


def wgmma_dq_key_tiles(q0: int, s: int, window=None) -> range:
    """The key tiles dq_wgmma_kernel visits for its queries q0 .. q0 + 63:
    every tile with a key the block can see."""
    first = max(0, q0 - window + 1) // WGMMA_TILE if window else 0
    return range(first, (min(q0 + WGMMA_BLOCK, s) - 1) // WGMMA_TILE + 1)


def wgmma_dkv_query_tiles(k0: int, s: int, window=None) -> range:
    """The query tiles (of each of the G heads) dkv_wgmma_kernel visits for
    its keys k0 .. k0 + 63: every tile with a query that sees one of them."""
    k1 = min(k0 + WGMMA_BLOCK, s) - 1
    return range(k0 // WGMMA_TILE,
                 (min(s - 1, k1 + window - 1) if window else s - 1) // WGMMA_TILE + 1)
