"""The LM slice's kernels (K4 rmsnorm, K5-K7 flash_gqa) against ``repro``.

On the CPU each wrapper runs its plain PyTorch version (a CUDA kernel has
no interpreter); ``chip_smoke.py`` holds the CUDA kernels against these
plain versions on the card.  The reference is ``repro``'s Pallas kernels
in interpret mode, as its own tests run them.

Tolerances:
- f32: rtol/atol 1e-5 — sums of at most 1,152 (rmsnorm) or 64 x 64
  (attention) f32 products taken in another order than the Pallas tiles,
  and the online softmax (``repro``) against one logsumexp (the plain
  version);
- bf16 outputs: one bf16 ulp (rtol 2**-7) — the f32 values agree to ~1e-6,
  so a value next to a rounding boundary may round the other way.
"""
import ctypes
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_gqa import kernel as j_kernel
from repro.kernels.flash_gqa.ops import flash_gqa as j_flash_gqa
from repro.kernels.rmsnorm.ops import rmsnorm as j_rmsnorm
from repro_torch.kernels.flash_gqa import grid
from repro_torch.kernels.flash_gqa import ops as flash_ops
from repro_torch.kernels.flash_gqa.ref import visible_mask
from repro_torch.kernels.rmsnorm import ops as rms_ops

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2.0**-7, atol=1e-6)


def _pair(a, dtype):
    """The same numpy values as a JAX array and a torch tensor of ``dtype``."""
    a = a.astype(np.float32)
    return (jnp.asarray(a).astype(getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# -- K4 rmsnorm ------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,d", [(37, 256), (19, 1152)])  # ragged row counts
def test_rmsnorm_forward_and_grad_match_repro_interpret(rows, d, dtype):
    rng = np.random.RandomState(rows)
    (jx, tx), (js, ts), (jg, tg) = (_pair(a, dtype) for a in (
        rng.randn(2, rows, d) * 3.0, 0.5 * rng.randn(d), rng.randn(2, rows, d)))
    want, vjp = jax.vjp(lambda x, s: j_rmsnorm(x, s, 1e-6, interpret=True), jx, js)
    wgx, wgs = vjp(jg)

    tx.requires_grad_()
    ts.requires_grad_()
    got = rms_ops.rmsnorm(tx, ts, 1e-6)
    ggx, ggs = torch.autograd.grad(got, (tx, ts), tg)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert got.dtype == tx.dtype and ggx.dtype == tx.dtype and ggs.dtype == ts.dtype
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    np.testing.assert_allclose(_np(ggx), _np(wgx), **tol)
    # the scale gradient sums over all 2 x rows rows: f32 order noise on
    # sums of magnitude up to ~100, so an absolute floor of 1e-4 besides
    np.testing.assert_allclose(_np(ggs), _np(wgs), rtol=tol["rtol"], atol=1e-4)
    assert rms_ops.LAUNCHES["rmsnorm"] == 0  # CPU: the plain version, no launch


def test_rmsnorm_impls():
    x, s = torch.randn(4, 64), torch.randn(64)
    torch.testing.assert_close(rms_ops.rmsnorm(x, s, impl="reference"),
                               rms_ops.rmsnorm(x, s, impl="auto"), rtol=0, atol=0)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        rms_ops.rmsnorm(x, s, impl="kernel")
    with pytest.raises(ValueError, match="no counterpart"):
        rms_ops.rmsnorm(x, s, impl="kernel_interpret")


@pytest.mark.parametrize("bad", ["scale_shape", "dtype_mix", "float64", "strided"])
def test_rmsnorm_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x, s = torch.randn(8, 64), torch.randn(64)
    if bad == "scale_shape":
        s = s[:63]
    elif bad == "dtype_mix":
        s = s.bfloat16()
    elif bad == "float64":
        x, s = x.double(), s.double()
    else:
        x = x[:, ::2]
        s = s[:32]
    with pytest.raises(ValueError):
        rms_ops.rmsnorm_fwd(x, s)


# -- K5-K7 flash_gqa -------------------------------------------------------

B, S, D, BLK = 2, 64, 64, 16


def _qkv(h, kv, dtype, seed=0, d=D):
    rng = np.random.RandomState(seed)
    arrays = (rng.randn(B, S, h, d), rng.randn(B, S, kv, d), rng.randn(B, S, kv, d),
              rng.randn(B, S, h, d))
    return zip(*(_pair(a, dtype) for a in arrays))


@pytest.mark.parametrize("g,window,softcap,d", [
    pytest.param(g, window, softcap, d, id=f"{g}-{window}-{softcap}" + ("" if d == D else f"-d{d}"))
    for d in (D, 80, 128) for g in (1, 4) for window in (None, 16) for softcap in (None, 50.0)])
def test_flash_forward_lse_and_grads_match_repro_interpret(g, window, softcap, d):
    """Forward, LSE and (dq, dk, dv); at window 16 with 16-blocks the Pallas
    grid is pruned (3 of 4 k-blocks per q row).  Also at head_dim 80,
    zamba2's shared attention, and 128 (internvl2, olmoe, granite-3-8b),
    which the wrappers take as they take 64."""
    h, kv = 4, 4 // g
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _qkv(h, kv, "float32", d=d)
    if window is not None:
        assert j_kernel.flash_gqa_grid(S, BLK, BLK, window) == (4, 3)
    kw = dict(window=window, softcap=softcap)
    j_out, j_lse = j_kernel.flash_gqa_pallas(
        *(jnp.swapaxes(t, 1, 2) for t in (jq, jk, jv)), bq=BLK, bk=BLK,
        interpret=True, return_residual=True, **kw)
    t_out, t_lse = flash_ops.flash_fwd(tq, tk, tv, **kw)
    np.testing.assert_allclose(_np(t_out), _np(jnp.swapaxes(j_out, 1, 2)), **F32_TOL)
    np.testing.assert_allclose(_np(t_lse), _np(j_lse), **F32_TOL)

    _, vjp = jax.vjp(lambda q, k, v: j_flash_gqa(q, k, v, bq=BLK, bk=BLK, interpret=True,
                                                 bwd="kernel_interpret", **kw), jq, jk, jv)
    j_grads = vjp(jdo)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = flash_ops.flash_gqa(*leaves, **kw)
    t_grads = torch.autograd.grad(out, leaves, tdo)
    for name, a, b in zip(("dq", "dk", "dv"), t_grads, j_grads):
        np.testing.assert_allclose(_np(a), _np(b), err_msg=name, **F32_TOL)
    assert flash_ops.LAUNCHES == {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                                  "flash_bwd_dkv_sum": 0, "flash_fwd_f32": 0,
                                  "flash_bwd_dq_f32": 0, "flash_bwd_dkv_f32": 0}


def test_flash_bf16_and_reference_impl():
    """bf16 operands: the plain forward against repro's interpret kernel to
    one bf16 ulp; the port's oracle ("reference") against the plain path."""
    (jq, jk, jv, _), (tq, tk, tv, _) = _qkv(4, 1, "bfloat16", seed=1)
    j_out = j_flash_gqa(jq, jk, jv, window=16, softcap=50.0, bq=BLK, bk=BLK, interpret=True)
    t_out = flash_ops.flash_gqa(tq, tk, tv, window=16, softcap=50.0)
    assert t_out.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(t_out), _np(j_out), rtol=2.0**-7, atol=2.0**-8)
    ref = flash_ops.flash_gqa(tq.float(), tk.float(), tv.float(), window=16, softcap=50.0,
                              impl="reference")
    np.testing.assert_allclose(_np(ref), _np(flash_ops.flash_gqa(
        tq.float(), tk.float(), tv.float(), window=16, softcap=50.0)), **F32_TOL)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        flash_ops.flash_gqa(tq, tk, tv, impl="kernel")


@pytest.mark.parametrize("bad", ["kv_heads", "lse_shape", "strided", "dtype_mix", "window"])
def test_flash_wrappers_reject_what_the_kernels_do_not_take(bad):
    (_, _, _, _), (q, k, v, do) = _qkv(4, 2, "float32")
    lse = delta = torch.zeros(B, 4, S)
    window = None
    if bad == "kv_heads":
        k = v = torch.zeros(B, S, 3, D)
    elif bad == "lse_shape":
        lse = torch.zeros(B, S, 4)
    elif bad == "strided":
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "dtype_mix":
        do = do.bfloat16()
    else:
        window = 0
    with pytest.raises(ValueError):
        flash_ops.flash_bwd_dq(q, k, v, do, lse, delta, window=window)
    with pytest.raises(ValueError):
        flash_ops.flash_bwd_dkv(q, k, v, do, lse, delta, window=window)


# -- grids -----------------------------------------------------------------


@pytest.mark.parametrize("s,bq,bk,window", [
    (4096, 512, 512, 512),     # gemma3-1b train_4k
    (32768, 512, 512, 4096),   # gemma2-9b prefill_32k
    (2048, 512, 512, 512),     # the LM slice on the card
    (1024, 512, 512, 512),
    (64, 16, 16, 16), (256, 32, 32, 40), (100, 512, 512, None)])
def test_grid_helpers_equal_repro(s, bq, bk, window):
    assert grid.flash_gqa_grid(s, bq, bk, window) == j_kernel.flash_gqa_grid(s, bq, bk, window)
    assert (grid.flash_gqa_bwd_grid(s, bq, bk, window)
            == j_kernel.flash_gqa_bwd_grid(s, bq, bk, window))
    bq_, bk_, nq, _ = grid._block_sizes(s, bq, bk)
    _, nkp = grid.flash_gqa_grid(s, bq, bk, window)
    for qi in range(nq):
        assert grid._first_kv_block(qi, bq_, bk_, nkp) == int(
            j_kernel._first_kv_block(qi, bq_, bk_, nkp))


def test_tile_census():
    """The numbers the benchmarks quote (ROADMAP.md queue 2)."""
    assert grid.flash_gqa_grid(4096, 512, 512, 512) == (8, 3)
    nq, nk = grid.flash_gqa_grid(4096, 512, 512, 512, prune_window=False)
    nk_dq, nq_dkv = grid.flash_gqa_bwd_grid(4096, 512, 512, 512)
    assert (nq * nk_dq + nk * nq_dkv, 2 * nq * nk) == (48, 128)
    assert grid.flash_gqa_grid(32768, 512, 512, 4096)[1] == 10
    assert grid.flash_gqa_grid(32768, 512, 512, 4096, prune_window=False)[1] == 64
    # the slice's seq_len is the smallest that prunes repro's 512-blocks
    assert grid.flash_gqa_grid(2048, 512, 512, 512) == (4, 3)
    assert grid.flash_gqa_grid(1024, 512, 512, 512) == (2, 2)


@pytest.mark.parametrize("s,window", [(2048, 512), (2048, None), (100, 16), (64, 1), (200, 300)])
def test_attention_pairs_counts_the_visible_pairs(s, window):
    assert visible_mask(s, window, "cpu").sum().item() == grid.attention_pairs(s, window)


_TILE_CASES = [(2048, 512), (2048, None), (100, 16), (64, 1), (200, 300), (1000, 512),
               (1000, None), (40, 16), (300, 1)]


def _query_tiles(mask, k0, keys):
    """64-query tiles holding a visible pair of keys k0 .. k0 + keys - 1."""
    hit = mask[:, k0:k0 + keys].any(1)
    return sorted({i // grid.SM90_TILE for i in hit.nonzero().flatten().tolist()})


def _check_sm90_tile_ranges(s, window, dq_keys, dkv_keys, constants,
                            fwd_keys=grid.SM90_TILE):
    """Every visible (query, key) pair lies in a visited tile, and no
    visited tile is fully masked: for each K5 and K6 block (128 rows; ``fwd_keys``-
    and ``dq_keys``-key tiles), each of its warpgroups (64 rows), each K7
    block of ``dkv_keys`` keys and, where a block holds more than 64, each
    of its warpgroups' 64 keys; and for K5 at query offsets (multiples of
    the 128-row query tile, the rank's rows to the end or 200 of them), each
    local block and warpgroup.  ``constants``: the source's widths."""
    src = flash_ops.SM90_SOURCE.read_text()
    for line in constants:
        assert line in src, line
    mask = visible_mask(s, window, "cpu")

    def key_tiles(q0, rows, keys, m=mask):
        hit = m[q0:q0 + rows].any(0)
        return sorted({j // keys for j in hit.nonzero().flatten().tolist()})

    rows = grid.SM90_FWD_ROWS
    for tiles_of, keys in ((functools.partial(grid.sm90_fwd_key_tiles, keys=fwd_keys), fwd_keys),
                           (functools.partial(grid.sm90_dq_key_tiles, keys=dq_keys), dq_keys)):
        for q0 in range(0, s, rows):
            assert list(tiles_of(q0, rows, s, window)) == key_tiles(q0, rows, keys), q0
            for r0 in (q0, q0 + rows // 2):
                want = key_tiles(r0, rows // 2, keys)
                assert list(tiles_of(r0, rows // 2, s, window)) == want, (keys, r0)
    for q0 in range(rows, s, rows):
        for sq in {s - q0, min(200, s - q0)}:
            rank = mask[q0:q0 + sq, :q0 + sq]
            assert torch.equal(rank, visible_mask(q0 + sq, window, "cpu", q0, sq))
            for r0 in range(0, sq, rows):
                for lo, n in ((r0, rows), (r0, rows // 2), (r0 + rows // 2, rows // 2)):
                    got = grid.sm90_fwd_key_tiles(lo, n, q0 + sq, window, q0, sq, fwd_keys)
                    assert list(got) == key_tiles(lo, n, fwd_keys, rank), (q0, sq, lo, n)
    per = dkv_keys // grid.SM90_TILE  # warpgroups of a K7 block
    for kb in range(-(-s // dkv_keys)):
        want = _query_tiles(mask, kb * dkv_keys, dkv_keys)
        assert list(grid.sm90_dkv_query_tiles(kb, s, window, dkv_keys)) == want, kb
        for w in range(per if per > 1 else 0):
            kt = kb * per + w
            want = _query_tiles(mask, kt * grid.SM90_TILE, grid.SM90_TILE)
            assert list(grid.sm90_dkv_query_tiles(kt, s, window)) == want, (kb, w)


@pytest.mark.parametrize("s,window", _TILE_CASES)
def test_sm90_tile_ranges_visit_exactly_the_tiles_with_visible_pairs(s, window):
    """The tile ranges of flash_gqa_sm90.cu (mirrored in grid.py) of the
    kernels shaped for head_dim 256: K5 (``fwd_kernel``, 256 only) blocks of
    128 rows over 64-key tiles, K6 (128 and 256) over 32-key tiles, K7 key
    tiles of 64 (``_check_sm90_tile_ranges``)."""
    _check_sm90_tile_ranges(s, window, grid.SM90_DQ_KEYS, grid.SM90_TILE, (
        f"constexpr int kTile = {grid.SM90_TILE};",
        f"constexpr int kDqKeys = {grid.SM90_DQ_KEYS};"))


_NARROW_CONSTANTS = (
    f"constexpr int kTile = {grid.SM90_TILE};",
    f"constexpr int kFwdNarrowKeys = {grid.SM90_FWD_NARROW_KEYS};",
    f"constexpr int kDqNarrowKeys = {grid.SM90_DQ_NARROW_KEYS};",
    f"constexpr int kDkvNarrowKeys = {grid.SM90_DKV_NARROW_KEYS};")


def _launch_body(src, launch, d=None):
    """The body of ``int launch_<launch>`` (``launch_<launch><d>`` for an
    explicit specialization) in the source."""
    name = launch if d is None else f"{launch}<{d}>"
    body = re.search(r"\nint launch_" + re.escape(name) + r"\(.*?\n}", src, re.S)
    return body and body.group(0)


@pytest.mark.parametrize("s,window", _TILE_CASES + [(1100, None), (1100, 512), (1040, 512)])
def test_sm90_tile_ranges_at_head_dim_80_visit_exactly_the_tiles_with_visible_pairs(s, window):
    """The same at head_dim 80 (fwd_narrow_kernel, dq_narrow_kernel,
    dkv_narrow_kernel): K5 and K6 over 128-key tiles, K7 blocks of 128 keys
    and each warpgroup's 64."""
    _check_sm90_tile_ranges(s, window, grid.SM90_DQ_NARROW_KEYS, grid.SM90_DKV_NARROW_KEYS,
                            _NARROW_CONSTANTS, grid.SM90_FWD_NARROW_KEYS)


@pytest.mark.parametrize("s,window", _TILE_CASES + [(1100, None), (1100, 512), (1040, 512)])
def test_sm90_tile_ranges_at_head_dim_64_visit_exactly_the_tiles_with_visible_pairs(s, window):
    """The same at head_dim 64, which runs the same narrow kernels (their
    launches are ``launch_*_narrow<64>``): K5 and K6 over 128-key tiles, K7
    blocks of 128 keys and each warpgroup's 64."""
    src = flash_ops.SM90_SOURCE.read_text()
    for launch in ("fwd", "dq", "dkv"):
        assert f"launch_{launch}_narrow<64>(" in _launch_body(src, launch, 64), launch
    _check_sm90_tile_ranges(s, window, grid.SM90_DQ_NARROW_KEYS, grid.SM90_DKV_NARROW_KEYS,
                            _NARROW_CONSTANTS, grid.SM90_FWD_NARROW_KEYS)


@pytest.mark.parametrize("s,window", _TILE_CASES + [(1100, None), (1100, 512), (1040, 512)])
def test_sm90_tile_ranges_at_head_dim_128_visit_exactly_the_tiles_with_visible_pairs(s, window):
    """The same at head_dim 128, which runs the narrow kernels of all three
    passes (``launch_fwd<128>``, ``launch_dq<128>`` and ``launch_dkv<128>``
    are ``launch_*_narrow<128>``): K5's and K6's 128-key tiles (the same
    at every narrow width; at 128 K6's ring holds 2 stages), K7 blocks of
    128 keys and each warpgroup's 64,
    for each block, warpgroup and query offset; dq_kernel's 32-key tiles and
    dkv_kernel's 64-key blocks are not launched at 128."""
    src = flash_ops.SM90_SOURCE.read_text()
    for launch in ("fwd", "dq", "dkv"):
        assert f"launch_{launch}_narrow<128>(" in _launch_body(src, launch, 128), launch
    layout = re.search(r"\nstruct DqNarrowLayout \{.*?\n};", src, re.S).group(0)
    assert "static constexpr int kKV = TileN<D>::bytes(kDqNarrowKeys);" in layout
    assert "static constexpr int kStages = D == 128 ? 2 : 4;" in layout
    narrow = _launch_body(src, "dq_narrow")
    assert narrow.count("kDqNarrowKeys)) return err;") == 2 and "kDqKeys" not in narrow
    _check_sm90_tile_ranges(s, window, grid.SM90_DQ_NARROW_KEYS, grid.SM90_DKV_NARROW_KEYS,
                            _NARROW_CONSTANTS, grid.SM90_FWD_NARROW_KEYS)


@pytest.mark.parametrize("s,window", [(1000, None), (1000, 512), (1100, None), (1100, 512),
                                      (1040, 512), (40, 16), (2048, 512), (128, None)])
def test_sm90_d80_dkv_warpgroups_own_the_block_tiles(s, window):
    """K7 at head_dim 64, 80 and 128 (dkv_narrow_kernel<D>, the same template
    at each width): a 128-key block's query tiles are the union of its two
    warpgroups' ranges (each held to the mask), each a run from the
    warpgroup's diagonal tile, so a warpgroup skips only a block's first
    tile (the second's keys start one tile later) and its last ones (the
    window, or keys that all lie past S: none then)."""
    src = flash_ops.SM90_SOURCE.read_text()
    narrow = _launch_body(src, "dkv_narrow")
    assert "(sh.s + kDkvNarrowKeys - 1) / kDkvNarrowKeys" in narrow  # a block per 128 keys
    mask = visible_mask(s, window, "cpu")
    keys, per = grid.SM90_DKV_NARROW_KEYS, grid.SM90_DKV_NARROW_KEYS // grid.SM90_TILE
    for d in flash_ops.NARROW_HEAD_DIMS:
        assert f"launch_dkv_narrow<{d}>(" in _launch_body(src, "dkv", d), d
        for kb in range(-(-s // keys)):
            block = list(grid.sm90_dkv_query_tiles(kb, s, window, keys))
            wgs = [list(grid.sm90_dkv_query_tiles(kb * per + w, s, window)) for w in range(per)]
            assert sorted(set(wgs[0]) | set(wgs[1])) == block, (d, kb)
            for w, tiles in enumerate(wgs):
                k0 = (kb * per + w) * grid.SM90_TILE
                assert tiles == _query_tiles(mask, k0, grid.SM90_TILE), (d, kb, w)
                if k0 >= s:
                    assert tiles == [], (d, kb, w)
                else:
                    assert tiles[0] == k0 // grid.SM90_TILE == block[0] + w, (d, kb, w)
                    assert tiles == list(range(tiles[0], tiles[-1] + 1)), (d, kb, w)


@pytest.mark.parametrize("d", flash_ops.NARROW_HEAD_DIMS)
def test_sm90_head_dim_80_backward_runs_its_own_kernels(d):
    """The bf16 dq and dk/dv passes at head_dim 64, 80 and 128
    (``NARROW_HEAD_DIMS``) launch dq_narrow_kernel<D> and
    dkv_narrow_kernel<D> (128-key tiles and blocks at the true width, their
    own layouts and tensor maps), through launch_dq<D> / launch_dkv<D>
    specialized to launch_*_narrow<D>; 256 still launches dq_kernel<D> /
    dkv_kernel<D>, which are instantiated at no narrow width; the forward's
    persistent kernel runs at the same widths
    (``test_sm90_narrow_forward_runs_its_own_kernel``)."""
    src = flash_ops.SM90_SOURCE.read_text()
    for launch, kernel, layout in (("dq", "dq_narrow_kernel", "DqNarrowLayout"),
                                   ("dkv", "dkv_narrow_kernel", "DkvNarrowLayout")):
        assert f"launch_{launch}_narrow<{d}>(" in _launch_body(src, launch, d), launch
        narrow = _launch_body(src, f"{launch}_narrow")
        assert f"{kernel}<D, false>" in narrow and f"{kernel}<D, true>" in narrow, launch
        assert f"{layout}<D>" in narrow and "make_maps_narrow<D>(" in narrow, launch
        assert f"{launch}_kernel<" not in narrow, launch
        generic = _launch_body(src, launch)
        assert f"{launch}_kernel<D, false>" in generic and f"{launch}_kernel<D, true>" in generic
    for launch, dims in (("fwd", flash_ops.FWD_NARROW_HEAD_DIMS),
                         ("dq", flash_ops.NARROW_HEAD_DIMS), ("dkv", flash_ops.NARROW_HEAD_DIMS)):
        found = re.findall(r"template <>\nint launch_" + launch + r"<(\d+)>", src)
        assert found == [str(x) for x in dims], launch
    assert f"dtype == 1 && d == {d}) return LAUNCH<{d}>" in src
    maps = re.search(r"\nint make_maps_narrow\(.*?\n}", src, re.S).group(0)
    assert "maps[1] = maps[0];" in maps and "CU_TENSOR_MAP_SWIZZLE_32B" in maps


@pytest.mark.parametrize("d", flash_ops.HEAD_DIMS)
def test_sm90_narrow_forward_runs_its_own_kernel(d):
    """bf16 K5 at head_dim 64, 80 and 128 launches the persistent
    fwd_narrow_kernel<D> (128-key tiles at the true width, its own layout
    and tensor maps: two a tensor at 80, 16-column boxes with a 32-byte
    swizzle; at 128 one map read at columns 0 and 64), at 256
    fwd_kernel<D> as before, so fwd_kernel is instantiated at 256 only; the
    C entry still dispatches every head_dim through launch_fwd."""
    src = flash_ops.SM90_SOURCE.read_text()
    body = re.search(r"\nint launch_fwd<" + str(d) + r">\(.*?\n}", src, re.S)
    assert flash_ops.FWD_NARROW_HEAD_DIMS == (64, 80, 128)
    if d in flash_ops.FWD_NARROW_HEAD_DIMS:
        assert body and f"launch_fwd_narrow<{d}>(" in body.group(0)
        narrow = re.search(r"\nint launch_fwd_narrow\(.*?\n}", src, re.S).group(0)
        assert "fwd_narrow_kernel<D>" in narrow and "FwdNarrowLayout<D>" in narrow
        assert "make_maps_narrow<D>(" in narrow and "fwd_kernel<" not in narrow
    else:
        assert body is None
        generic = re.search(r"\nint launch_fwd\(.*?\n}", src, re.S).group(0)
        assert "fwd_kernel<D>" in generic and "FwdLayout<D>" in generic
    assert re.findall(r"template <>\nint launch_fwd<(\d+)>", src) == ["64", "80", "128"]
    assert f"dtype == 1 && d == {d}) return LAUNCH<{d}>" in src
    tile = re.search(r"\nstruct TileN \{.*?\n};", src, re.S).group(0)
    assert "D == 64 || D == kD80 || D == 128" in tile
    assert "if constexpr (D == 128) tma_load(dst + rows * 128, wide, bar, 64," in tile


@pytest.mark.parametrize("d", flash_ops.HEAD_DIMS)
def test_sm90_narrow_forward_takes_a_positive_scale_only(d):
    """bf16 K5 at head_dim 64, 80 and 128 (``FWD_NARROW_HEAD_DIMS``) refuses
    a scale <= 0 (its softmax takes the row max on the raw scores), in the
    wrapper on card-side (meta) tensors and in the source's launch; 256, f32
    and the plain version on the CPU take any scale."""
    src = flash_ops.SM90_SOURCE.read_text()
    narrow = re.search(r"\nint launch_fwd_narrow\(.*?\n}", src, re.S).group(0)
    assert "if (!(sh.scale > 0.f)) return (int)cudaErrorInvalidValue;" in narrow
    assert flash_ops.FWD_NARROW_HEAD_DIMS == (64, 80, 128)
    assert flash_ops.NARROW_HEAD_DIMS == (64, 80, 128)
    q = torch.empty(1, 128, 2, d, dtype=torch.bfloat16, device="meta")
    for scale in (-0.1, 0.0):
        if d in flash_ops.FWD_NARROW_HEAD_DIMS:
            with pytest.raises(ValueError, match="positive scale"):
                flash_ops.flash_fwd(q, q, q, scale=scale)
        else:
            flash_ops.flash_fwd(q, q, q, scale=scale)
        flash_ops.flash_fwd(q.float(), q.float(), q.float(), scale=scale)
    x = torch.from_numpy(np.random.default_rng(d).standard_normal((1, 8, 2, d))).bfloat16()
    out, lse = flash_ops.flash_fwd(x, x, x, scale=-0.1)
    want, want_lse = flash_ops.flash_fwd_plain(x, x, x, scale=-0.1)
    assert torch.equal(out, want) and torch.equal(lse, want_lse)
    assert torch.isfinite(out.float()).all()


@pytest.mark.parametrize("d", (128, 256))
def test_sm90_backward_at_head_dim_128_runs_the_wide_kernels_at_any_scale(d):
    """bf16 K6 and K7 at head_dim 128 launch the narrow backward
    (launch_dq<128> / launch_dkv<128> are launch_*_narrow<128>), at 256
    dq_kernel<D> and dkv_kernel<D> (no specialization there); neither
    backward takes a positive-scale rule (its softmax is the forward's LSE,
    no row max), and the wrappers take a scale <= 0 on card-side (meta)
    tensors, recording one launch each."""
    from repro_torch.kernels import meta

    src = flash_ops.SM90_SOURCE.read_text()
    assert (d in flash_ops.NARROW_HEAD_DIMS) == (d == 128)
    for launch in ("dq", "dkv"):
        generic = _launch_body(src, launch)
        assert f"{launch}_kernel<D, false>" in generic and "sh.scale" not in generic, launch
        narrow = _launch_body(src, f"{launch}_narrow")
        assert f"{launch}_narrow_kernel<D, false>" in narrow and "sh.scale" not in narrow, launch
        if d == 128:
            assert f"launch_{launch}_narrow<128>(" in _launch_body(src, launch, d), launch
        else:
            assert _launch_body(src, launch, d) is None, launch
    q = torch.empty(1, 128, 4, d, dtype=torch.bfloat16, device="meta")
    k = torch.empty(1, 128, 2, d, dtype=torch.bfloat16, device="meta")
    rows = torch.empty(1, 4, 128, dtype=torch.float32, device="meta")
    for scale in (-0.1, 0.0):
        with meta.census() as c:
            dq = flash_ops.flash_bwd_dq(q, k, k, q, rows, rows, scale=scale)
            dk, dv = flash_ops.flash_bwd_dkv(q, k, k, q, rows, rows, scale=scale)
        assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
        assert c.launches == {"flash_bwd_dq": 1, "flash_bwd_dkv": 1, "flash_bwd_dkv_sum": 1}
    assert flash_ops.LAUNCHES["flash_bwd_dq"] == flash_ops.LAUNCHES["flash_bwd_dkv"] == 0


@pytest.mark.parametrize("d", flash_ops.FWD_NARROW_HEAD_DIMS)
def test_sm90_narrow_forward_layout_fits_a_block(d):
    """Each ``FwdNarrowLayout<D>`` (two Q buffers, a K ring and a V ring of
    128-key bf16 tiles at the true width, the two warpgroups' 64-row O
    tiles, then the mbarriers and the 1 KB alignment slack), computed from
    the source's own constants and lines, fits the 232,448 bytes of shared
    memory a block may take on Hopper, and the source asserts it too.  At
    D = 128 4-stage rings (those of D = 64 and 80) would not: 352 KB."""
    src = flash_ops.SM90_SOURCE.read_text()
    for line in ("static constexpr int kQRows = 2 * kTile;",
                 "static constexpr int kQ = TileN<D>::bytes(kQRows);",
                 "static constexpr int kKV = TileN<D>::bytes(kFwdNarrowKeys);",
                 "static constexpr int kO = TileN<D>::bytes(kTile);",
                 "static constexpr int kBars = kFwdNarrowQBufs * kQ + 2 * kStages * kKV + 2 * kO;",
                 "static constexpr int kBytes = kBars + 2 * (kFwdNarrowQBufs + 2 * kStages) * 8 "
                 "+ 1024;",
                 "static_assert(kBytes <= 232448,",
                 "static constexpr int bytes(int rows) { return rows * 2 * D; }",
                 f"constexpr int kFwdNarrowKeys = {grid.SM90_FWD_NARROW_KEYS};"):
        assert line in src, line
    qbufs = int(re.search(r"constexpr int kFwdNarrowQBufs = (\d+);", src).group(1))
    at128, other = map(int, re.search(r"static constexpr int kStages = D == 128 \? (\d+) : (\d+);",
                                      src).groups())
    stages = at128 if d == 128 else other
    assert qbufs == 2 and stages >= 2

    def total(stages):
        rows, keys = 2 * grid.SM90_TILE, grid.SM90_FWD_NARROW_KEYS
        return (qbufs * rows * 2 * d + 2 * stages * keys * 2 * d + 2 * grid.SM90_TILE * 2 * d
                + 2 * (qbufs + 2 * stages) * 8 + 1024)

    assert total(stages) <= 232448, (d, total(stages))
    if d == 128:
        assert total(other) > 232448


def _layout(src, name):
    """The body of ``struct <name>`` in the source."""
    return re.search(r"\nstruct " + name + r" \{.*?\n};", src, re.S).group(0)


@pytest.mark.parametrize("d", flash_ops.NARROW_HEAD_DIMS)
@pytest.mark.parametrize("kernel", ["dq", "dkv"])
def test_sm90_narrow_backward_layouts_fit_a_block(kernel, d):
    """``DqNarrowLayout<D>`` (Q and dO of the block's 128 rows resident, a
    ring of K/V stages of ``kDqNarrowKeys`` keys) and ``DkvNarrowLayout<D>`` (K and
    V of the block's 128 keys resident, a ring of Q/dO stages of 64 queries
    with their lse and delta rows), then the mbarriers and the 1 KB alignment slack,
    computed from the source's own constants and lines, fit the 232,448
    bytes of shared memory a block may take on Hopper, and the source
    asserts it too.  At D = 128 K6's ring holds 2 stages: the 4 of D = 64
    and 80 would take 263 KB."""
    src = flash_ops.SM90_SOURCE.read_text()
    keys = grid.SM90_DQ_NARROW_KEYS if kernel == "dq" else grid.SM90_DKV_NARROW_KEYS
    assert f"constexpr int kDqNarrowKeys = {grid.SM90_DQ_NARROW_KEYS};" in src
    assert f"constexpr int kDkvNarrowKeys = {grid.SM90_DKV_NARROW_KEYS};" in src
    assert f"constexpr int kTile = {grid.SM90_TILE};" in src
    assert "static constexpr int bytes(int rows) { return rows * 2 * D; }" in src
    tile = lambda rows: rows * 2 * d  # noqa: E731
    if kernel == "dq":
        body = _layout(src, "DqNarrowLayout")
        for line in ("static constexpr int kRows = 2 * kTile;",
                     "static constexpr int kQ = TileN<D>::bytes(kRows);",
                     "static constexpr int kKV = TileN<D>::bytes(kDqNarrowKeys);",
                     "static constexpr int kStage = 2 * kKV;",
                     "static constexpr int kBars = 2 * kQ + kStages * kStage;",
                     "static constexpr int kBytes = kBars + (1 + 2 * kStages) * 8 + 1024;"):
            assert line in body, line
        at128, other = map(int, re.search(
            r"static constexpr int kStages = D == 128 \? (\d+) : (\d+);", body).groups())
        stages = at128 if d == 128 else other

        def total(stages):
            return (2 * tile(2 * grid.SM90_TILE) + stages * 2 * tile(keys)
                    + (1 + 2 * stages) * 8 + 1024)
    else:
        body = _layout(src, "DkvNarrowLayout")
        for line in ("static constexpr int kKV = TileN<D>::bytes(kDkvNarrowKeys);",
                     "static constexpr int kT = TileN<D>::bytes(kTile);",
                     "static constexpr int kStage = 2 * kT + 2 * kTile * 4;",
                     "static constexpr int kBars = 2 * kKV + kStages * kStage;",
                     "static constexpr int kBytes = kBars + (1 + 2 * kStages) * 8 + 1024;"):
            assert line in body, line
        stages = other = int(re.search(r"static constexpr int kStages = (\d+);", body).group(1))

        def total(stages):
            return (2 * tile(keys) + stages * (2 * tile(grid.SM90_TILE) + 2 * grid.SM90_TILE * 4)
                    + (1 + 2 * stages) * 8 + 1024)
    assert "static_assert(kBytes <= 232448," in body
    assert stages >= 2 and total(stages) <= 232448, (kernel, d, stages, total(stages))
    if kernel == "dq":
        assert (total(other) > 232448) == (d == 128), (d, total(other))


@pytest.mark.parametrize("b,h,n_qt", [(2, 32, 16), (2, 16, 16), (4, 32, 4), (4, 16, 4),
                                      (2, 8, 16), (4, 32, 8), (1, 3, 5), (2, 5, 300), (1, 32, 256),
                                      (3, 7, 9), (1, 1, 1)])
def test_sm90_narrow_forward_schedule_covers_every_item_and_balances(b, h, n_qt):
    """``fwd_narrow_kernel``'s persistent blocks (mirrored by
    ``grid.sm90_fwd_narrow_blocks``, its lines held to the source): every
    (batch*head, query tile) item runs exactly once, on a card of 132 SMs
    (the H100's) or fewer blocks; each block's items of one head group come
    heaviest first; and where every block has two rounds or more of causal
    items, no block's tiles exceed the mean over 132 SMs by more than 5 %."""
    src = flash_ops.SM90_SOURCE.read_text()
    for line in ("return k * p + ((k & 1) ? p - 1 - c : c);",
                 "hg = p >= n_qt ? min(bhs, p / n_qt) : bhs;",
                 "const int hg = n_qt <= sms ? min(sh.b * sh.h, sms / n_qt) : sh.b * sh.h;",
                 "min(items, n_qt <= sms ? hg * n_qt : sms)"):
        assert line in src, line
    sms = 132
    blocks = grid.sm90_fwd_narrow_blocks(b, h, n_qt, sms)
    assert len(blocks) <= sms
    done = sorted(it for blk in blocks for it in blk)
    assert done == [(bh, qt) for bh in range(b * h) for qt in range(n_qt)]
    tiles = [sum(qt + 1 for _, qt in blk) for blk in blocks]  # causal key tiles, S = 128 n_qt
    mean = sum(tiles) / sms
    if min(len(blk) for blk in blocks) >= 2:
        assert max(tiles) <= 1.05 * mean, (max(tiles), mean)
    hg = min(b * h, len(blocks) // n_qt) if len(blocks) >= n_qt else b * h
    for blk in blocks:
        for (bh0, q0), (bh1, q1) in zip(blk, blk[1:]):
            assert bh1 // hg > bh0 // hg or q1 <= q0


def test_dkv_sum_plain_adds_the_head_partials():
    """K7's bf16 path at G > 1: each query head's dk/dv partial (the dk/dv
    pass at G = 1 on that head alone), summed over the G heads by the sum
    pass, is the whole dk/dv -- to one bf16 ulp."""
    h, kv = 4, 2
    (_, _, _, _), (q, k, v, do) = _qkv(h, kv, "float32", seed=3)
    out, lse = flash_ops.flash_fwd(q, k, v, window=16, softcap=50.0)
    delta = flash_ops.row_delta(do, out)
    g = h // kv
    parts = [flash_ops.flash_bwd_dkv(
        q[:, :, i:i + 1].contiguous(), k[:, :, i // g:i // g + 1].contiguous(),
        v[:, :, i // g:i // g + 1].contiguous(), do[:, :, i:i + 1].contiguous(),
        lse[:, i:i + 1].contiguous(), delta[:, i:i + 1].contiguous(), window=16,
        softcap=50.0) for i in range(h)]
    pk, pv = (torch.cat([p[j] for p in parts], dim=2) for j in (0, 1))
    dk, dv = flash_ops.flash_bwd_dkv_sum(pk, pv, kv)
    want_k, want_v = flash_ops.flash_bwd_dkv(q, k, v, do, lse, delta, window=16, softcap=50.0)
    assert dk.dtype == dv.dtype == torch.bfloat16 and dk.shape == k.shape
    np.testing.assert_allclose(_np(dk), _np(want_k.bfloat16()), rtol=2.0**-7, atol=1e-6)
    np.testing.assert_allclose(_np(dv), _np(want_v.bfloat16()), rtol=2.0**-7, atol=1e-6)
    # the heads are added in order g = 0 .. G-1, as the kernel adds them
    x = pk.reshape(B, S, kv, g, D)
    assert torch.equal(dk, (((x[:, :, :, 0] + x[:, :, :, 1])).bfloat16()))
    with pytest.raises(ValueError):
        flash_ops.flash_bwd_dkv_sum(pk.bfloat16(), pv, kv)
    assert flash_ops.LAUNCHES["flash_bwd_dkv_sum"] == 0


@pytest.mark.parametrize("dtype,h,kv", [("bfloat16", 4, 2), ("float32", 4, 2),
                                        ("bfloat16", 4, 4)])
def test_dkv_partials_come_only_from_the_bf16_kernel_at_several_heads(dtype, h, kv):
    """K7's f32 head partials exist only where the tensor-core kernel writes
    them (bf16 CUDA tensors, G > 1); there is no plain version of them, so
    a CPU tensor raises, whatever its type, and nothing is launched."""
    (_, _, _, _), (q, k, v, do) = _qkv(h, kv, dtype)
    lse = delta = torch.zeros(B, h, S)
    with pytest.raises(ValueError, match="partials"):
        flash_ops.flash_bwd_dkv_partials(q, k, v, do, lse, delta)
    assert flash_ops.LAUNCHES["flash_bwd_dkv"] == 0


@pytest.mark.parametrize("bad", ["cpu", "float32", "dtype_mix"])
def test_wide_dq_comes_only_from_the_bf16_kernel(bad):
    """K6's f32 dq before its final rounding exists only where the
    tensor-core kernel computes it (bf16 CUDA tensors); there is no plain
    version of it, so CPU tensors, f32 and mixed types raise, and nothing is
    launched."""
    (_, _, _, _), (q, k, v, do) = _qkv(4, 1, "float32" if bad == "float32" else "bfloat16")
    if bad == "dtype_mix":
        do = do.float()
    lse = delta = torch.zeros(B, 4, S)
    with pytest.raises(ValueError, match="wide dq" if bad != "dtype_mix" else "bfloat16"):
        flash_ops.flash_bwd_dq_wide(q, k, v, do, lse, delta)
    assert flash_ops.LAUNCHES["flash_bwd_dq"] == 0


# -- the C interface --------------------------------------------------------

_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "int": ctypes.c_int, "long long": ctypes.c_longlong,
            "float": ctypes.c_float, "const char*": ctypes.c_char_p}


@pytest.mark.parametrize("source,signatures", [
    (rms_ops.SOURCE, rms_ops.SIGNATURES), (flash_ops.SOURCE, flash_ops.SIGNATURES),
    (flash_ops.SM90_SOURCE, flash_ops.SM90_SIGNATURES)],
    ids=["rmsnorm", "flash_gqa", "flash_gqa_sm90"])
def test_ctypes_signatures_match_the_cuda_source(source, signatures):
    """No compiler here: hold the ctypes declarations to the .cu's C
    interface, parameter by parameter."""
    src = source.read_text()
    for name, (argtypes, restype) in signatures.items():
        m = re.search(r'extern "C" ([\w ]+\*?) ?' + name + r"\(([^)]*)\)", src)
        assert m, name
        params = [re.sub(r"\s+\w+$", "", p.strip()) for p in m.group(2).split(",")]
        assert [_C_TYPES[p] for p in params] == argtypes, name
        assert _C_TYPES[m.group(1).strip()] is restype, name


def test_head_dims_match_the_source_dispatch():
    """The SIMT source takes float32 (dtype 0) only, at every head_dim the
    wrappers accept; bfloat16 runs flash_gqa_sm90.cu."""
    src = flash_ops.SOURCE.read_text()
    for d in flash_ops.HEAD_DIMS:
        assert f"dtype == 0 && d == {d}" in src
    assert "dtype == 1" not in src


def test_sm90_head_dims_match_the_source_dispatch():
    """The tensor-core source takes bf16 (dtype 1) only, at every head_dim
    the wrappers accept, for all three passes; float32 stays on
    flash_gqa.cu."""
    src = flash_ops.SM90_SOURCE.read_text()
    for d in flash_ops.HEAD_DIMS:
        assert f"dtype == 1 && d == {d}" in src
    assert "dtype == 0" not in src
    for entry, launch in (("fwd", "fwd"), ("bwd_dq", "dq"), ("bwd_dkv", "dkv")):
        body = re.search(r'extern "C" int flash_gqa_sm90_' + entry + r"\(.*?\n}", src, re.S)
        assert body and f"SM90_DISPATCH(launch_{launch}," in body.group(0), entry


# -- the f32 backward on the tensor cores (dq_tf32_kernel, dkv_tf32_kernel) --


@pytest.mark.parametrize("d", flash_ops.TF32_HEAD_DIMS)
def test_f32_backward_plain_versions_match_repro_interpret_at_two_heads_a_kv_head(d):
    """The plain dq and dk/dv passes, which ``chip_smoke.py`` holds the f32
    tensor-core kernels to, against ``repro``'s Pallas dq and dk/dv kernels
    in interpret mode at each width those kernels take: G = 2 (H 4 over KV
    2), window 16 (a pruned Pallas grid), softcap 50; the LSE and delta
    from the plain forward, as the kernels take them."""
    h, kv = 4, 2
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _qkv(h, kv, "float32", seed=3, d=d)
    kw = dict(window=16, softcap=50.0)
    _, vjp = jax.vjp(lambda q, k, v: j_flash_gqa(q, k, v, bq=BLK, bk=BLK, interpret=True,
                                                 bwd="kernel_interpret", **kw), jq, jk, jv)
    j_dq, j_dk, j_dv = vjp(jdo)
    out, lse = flash_ops.flash_fwd_plain(tq, tk, tv, **kw)
    delta = flash_ops.row_delta(tdo, out)
    t_dq = flash_ops.flash_bwd_dq_plain(tq, tk, tv, tdo, lse, delta, **kw)
    t_dk, t_dv = flash_ops.flash_bwd_dkv_plain(tq, tk, tv, tdo, lse, delta, **kw)
    assert t_dq.dtype == t_dk.dtype == torch.float32
    for name, a, b in (("dq", t_dq, j_dq), ("dk", t_dk, j_dk), ("dv", t_dv, j_dv)):
        np.testing.assert_allclose(_np(a), _np(b), err_msg=name, **F32_TOL)
    # the wrappers take these plain versions for CPU tensors
    assert torch.equal(flash_ops.flash_bwd_dq(tq, tk, tv, tdo, lse, delta, **kw), t_dq)


def _body(src, head):
    """The text from ``head`` to the end of its function (a closing brace at
    the start of a line)."""
    return re.search(re.escape(head) + r".*?\n}", src, re.S).group(0)


MMA_SYNC_DIMS = [d for d in flash_ops.TF32_HEAD_DIMS if d not in flash_ops.WGMMA_HEAD_DIMS]


@pytest.mark.parametrize("d", flash_ops.HEAD_DIMS)
def test_f32_backward_runs_the_tf32_kernels_at_64_80_and_128(d):
    """The f32 dq and dk/dv passes dispatch by width through
    FLASH_BWD_DISPATCH: at head_dim 64 (``WGMMA_HEAD_DIMS``) to
    launch_dq_wgmma<64> / launch_dkv_wgmma<64>, which launch
    dq_wgmma_kernel<D> / dkv_wgmma_kernel<D>; at 80 and 128 to
    launch_dq_tf32<D> / launch_dkv_tf32<D> (dq_tf32_kernel /
    dkv_tf32_kernel, mma.sync); at 256 to the SIMT launch_dq<256> /
    launch_dkv<256>.  The forward dispatches by width too, through
    FLASH_FWD_DISPATCH (``test_f32_forward_runs_the_tf32_kernel_at_64_80_and_128``)."""
    src = flash_ops.SOURCE.read_text()
    macro = re.search(r"#define FLASH_BWD_DISPATCH\(WGMMA, TF32, SIMT, \.\.\.\).*?while \(0\)",
                      src, re.S).group(0)
    route = ("WGMMA" if d in flash_ops.WGMMA_HEAD_DIMS else
             "TF32" if d in flash_ops.TF32_HEAD_DIMS else "SIMT")
    assert f"if (dtype == 0 && d == {d}) return {route}<{d}>(__VA_ARGS__);" in macro
    assert flash_ops.TF32_HEAD_DIMS == (64, 80, 128) and flash_ops.WGMMA_HEAD_DIMS == (64,)
    for entry, launch in (("bwd_dq", "dq"), ("bwd_dkv", "dkv")):
        body = _body(src, f'extern "C" int flash_gqa_{entry}(')
        assert f"FLASH_BWD_DISPATCH(launch_{launch}_wgmma, launch_{launch}_tf32, launch_{launch}," \
            in re.sub(r"\s+", " ", body), entry
        assert f"{launch}_wgmma_kernel<D>;" in _body(src, f"int launch_{launch}_wgmma(")
        assert f"{launch}_tf32_kernel<D>;" in _body(src, f"int launch_{launch}_tf32(")
        assert f"{launch}_kernel<D>;" in _body(src, f"int launch_{launch}(")
    assert "FLASH_FWD_DISPATCH(launch_fwd_tf32, launch_fwd," in _body(
        src, 'extern "C" int flash_gqa_fwd(')


@pytest.mark.parametrize("d", flash_ops.HEAD_DIMS)
def test_f32_forward_runs_the_tf32_kernel_at_64_80_and_128(d):
    """The f32 forward dispatches by width through FLASH_FWD_DISPATCH: at
    head_dim 64, 80 and 128 (``TF32_FWD_HEAD_DIMS``) to launch_fwd_tf32<D>,
    which launches fwd_tf32_kernel<D> (mma.sync, three TF32 products a
    product); at 256 to the SIMT launch_fwd<256> (fwd_kernel<D>)."""
    src = flash_ops.SOURCE.read_text()
    macro = re.search(r"#define FLASH_FWD_DISPATCH\(TF32, SIMT, \.\.\.\).*?while \(0\)",
                      src, re.S).group(0)
    route = "TF32" if d in flash_ops.TF32_FWD_HEAD_DIMS else "SIMT"
    assert f"if (dtype == 0 && d == {d}) return {route}<{d}>(__VA_ARGS__);" in macro
    assert macro.count("return TF32<") == 3 and macro.count("return SIMT<") == 1
    assert flash_ops.TF32_FWD_HEAD_DIMS == (64, 80, 128)
    assert "fwd_tf32_kernel<D>;" in _body(src, "int launch_fwd_tf32(")
    assert "fwd_kernel<D>;" in _body(src, "int launch_fwd(")
    assert "FLASH_DISPATCH(" not in src  # the one-route macro is gone


def test_f32_source_takes_no_atomics_and_splits_every_product():
    """No atomics in flash_gqa.cu (every sum in one fixed order: bitwise run
    to run; K7 folds the G heads itself); every tensor-core product of the
    f32 kernels (K5 too) is the three-term split (mma.sync: ``mma3``, lo*hi, hi*lo,
    hi*hi; wgmma: three ``wgmma_tf32`` in that order on an A and a B split
    into hi and lo, the first starting or continuing the sum, the others
    adding to it), never one TF32 product; the long sums (dq, dk, dv) take
    each tile's products from zero and add them in f32; the split rounds as
    cvt.rna.tf32.f32 does."""
    src = flash_ops.SOURCE.read_text()
    assert not re.search(r"\batomic\w*\s*\(|\batom\.|\bred\.", src)
    assert src.count("mma_tf32(c, ") == 3 and src.count("mma.sync.aligned") == 1
    mma3 = _body(src, "__device__ __forceinline__ void mma3(")
    assert re.findall(r"mma_tf32\(c, a\[0\]\.(\w+), .*?, b0\.(\w), b1\.(\w)\);", mma3) == [
        ("lo", "x", "x"), ("hi", "y", "y"), ("hi", "x", "x")]  # (hi, lo) pairs: x hi, y lo
    # K6: S, dP, dQ; K7: S^T, dP^T, dV, dK, with dP^T and dK written once for
    # a warp holding 16 keys alone and once for the second warp of a pair
    # K5: S and O += P V, once each
    for kernel, scores, long_sums in (("fwd_tf32_kernel", 1, 1), ("dq_tf32_kernel", 2, 1),
                                      ("dkv_tf32_kernel", 3, 3)):
        body = _body(src, f"{kernel}(const float* __restrict__ q")
        assert "mma_tf32(" not in body and "mma3(" not in body
        assert body.count("mma_abt<") == scores and body.count("mma_ab<") == long_sums, kernel
    # the long sums take each k-step's products from zero, then add in f32
    mma_ab = _body(src, "__device__ __forceinline__ void mma_ab(")
    assert "float part[kChunk][4] = {};" in mma_ab
    assert "for (int i = 0; i < 4; ++i) c[n0 + n][i] += part[n][i];" in mma_ab
    # wgmma: every product a run of three (A lo, B hi), (A hi, B lo), (A hi,
    # B hi) into one accumulator (names ending in l / h are lo / hi halves;
    # an A lo half from shared memory is wgmma_tf32_ss's, N = 32)
    calls = re.findall(r"wgmma_tf32(?:<(\w+)>|_ss)\((\w+), (\w+)(?:\[\w+\]|\(\w+\))?, (\w+), "
                       r"([^;]+)\);", src)
    assert len(calls) == 3 * 6, calls  # K6: S, dP, dQ; K7: S^T, dP^T, dV then dK (``products``)
    for i in range(0, len(calls), 3):
        (n0, c0, a0, b0, f0), (n1, c1, a1, b1, f1), (n2, c2, a2, b2, f2) = calls[i:i + 3]
        assert (n0 or "32") == n1 == n2 and c0 == c1 == c2, calls[i:i + 3]
        assert (a0[-1], b0[-1], a1[-1], b1[-1], a2[-1], b2[-1]) == tuple("lhhlhh"), calls[i:i + 3]
        assert a1 == a2 and a0[:-1] == a1[:-1] and b0 == b2 and b1[:-1] == b0[:-1]
        assert f1 == f2 == "1" and f0 != "1", calls[i:i + 3]
    for kernel, adds in (("dq_wgmma_kernel", ("acc[i] += part[i];",)),
                         ("dkv_wgmma_kernel", ("gv[i] += pv[i];", "gk[i] += pk[i];"))):
        body = _body(src, f"{kernel}(const float* __restrict__ q")
        assert "mma_tf32(" not in body and "mma3(" not in body
        for add in adds:
            assert add in body, (kernel, add)
        assert "kk > 0);" in body  # each tile's first long-sum product starts from zero
    to_tf32 = _body(src, "__device__ __forceinline__ uint32_t to_tf32(")
    assert "(__float_as_uint(x) + 0x1000u) & 0xffffe000u" in to_tf32
    # round to nearest, ties away from zero, at 10 mantissa bits: cvt.rna's
    x = np.float32(np.random.RandomState(0).randn(4096))
    bits = x.view(np.uint32)
    hi = ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)
    m, e = np.frexp(x.astype(np.float64))
    want = np.ldexp(np.sign(m) * np.floor(np.abs(m) * 2**11 + 0.5) / 2**11, e)
    assert np.array_equal(hi.astype(np.float64), want)


@pytest.mark.parametrize("d", flash_ops.WGMMA_HEAD_DIMS)
@pytest.mark.parametrize("kernel", ["dq", "dkv"])
def test_wgmma_backward_layouts_fit_a_block(kernel, d):
    """``DqWgLayout<D>`` (two stages of a 32-key tile's K and V, hi and lo
    as stored, and K's transposed; the lo tile of the block's 64 rows of dO;
    two buffers of dS) and ``DkvWgLayout<D>`` (two stages of a 32-query
    tile's Q and dO, hi and lo as stored and transposed; the lo tile of V;
    the stages' LSE and delta rows; two buffers of P^T and dS^T), computed from the source's own constants and lines, fit the
    232,448 bytes of shared memory a block may take on Hopper, every
    swizzled tile on a 1,024-byte boundary, and the source asserts it
    too."""
    src = flash_ops.SOURCE.read_text()
    for line in ("constexpr int kWgThreads = 384;", "constexpr int kWgKeys = 64;",
                 "constexpr int kWgQ = 32;", "constexpr int kWgStages = 2;",
                 "  static constexpr int kRows = kWgQ * D * 4;",
                 "  static constexpr int kCols = D * 128;",
                 "  static constexpr int kBytes = kBars + (2 * kWgStages + 4) * 8 + 1024;",
                 "constexpr size_t kMaxSmem = 232448;",
                 f"{'Dq' if kernel == 'dq' else 'Dkv'}WgLayout<{d}>::kBytes <= kMaxSmem"):
        assert line in src, line
    assert grid.WGMMA_BLOCK == 64 and grid.WGMMA_TILE == 32
    rows, cols, own = 32 * d * 4, d * 128, 64 * d * 4
    if kernel == "dq":
        layout = _body(src, "struct DqWgLayout {")
        for line in ("kStage = 4 * kRows + 2 * kCols;", "kLo = kWgStages * kStage;",
                     "kExch = kLo + kWgKeys * D * 4;", "kBars = kExch + 2 * 128 * 16 * 4;"):
            assert line in layout, line
        lo = 2 * (4 * rows + 2 * cols)
        total = lo + own + 2 * 128 * 16 * 4
    else:
        layout = _body(src, "struct DkvWgLayout {")
        for line in ("kStage = 4 * kRows + 4 * kCols;", "kLo = kWgStages * kStage;",
                     "kStats = kLo + kWgKeys * D * 4;",
                     "kExch = kStats + kWgStages * 2 * kWgQ * 4;",
                     "kBars = kExch + 2 * 128 * 32 * 4;"):
            assert line in layout, line
        lo = 2 * (4 * rows + 4 * cols)
        total = lo + own + 2 * 2 * 32 * 4 + 2 * 128 * 32 * 4
    assert rows % 1024 == 0 and cols % 1024 == 0 and lo % 1024 == 0
    total += (2 * 2 + 4) * 8 + 1024
    assert total <= 232448, (kernel, d, total)


@pytest.mark.parametrize("s,window", [(2048, 512), (2048, None), (100, 16), (64, 1), (40, 16),
                                      (200, 300), (1040, 512), (1100, None), (1100, 512)])
def test_wgmma_tile_ranges_hold_exactly_the_tiles_with_visible_pairs(s, window):
    """The f32 wgmma kernels' tile ranges (mirrored in grid.py, the source's
    lines asserted): each K6 block (64 queries) visits exactly the 32-key
    tiles holding a pair it sees, and each K7 block (64 keys) exactly the
    32-query tiles; the kernels skip no tile, so every tile visited must
    hold such a pair."""
    src = flash_ops.SOURCE.read_text()
    dq = _body(src, "dq_wgmma_kernel(const float* __restrict__ q")
    for line in ("const int q0 = (gridDim.y - 1 - blockIdx.y) * kWgKeys;",
                 "const int kt_first = sh.window > 0 ? max(0, q0 - sh.window + 1) / kWgQ : 0;",
                 "const int kt_last = (min(q0 + kWgKeys, sh.s) - 1) / kWgQ;"):
        assert line in dq, line
    dkv = _body(src, "dkv_wgmma_kernel(const float* __restrict__ q")
    for line in ("const int k0 = blockIdx.y * kWgKeys;",
                 "const int k1 = min(k0 + kWgKeys, sh.s) - 1;",
                 "const int qt_first = k0 / kWgQ;",
                 "const int qt_last = (sh.window > 0 ? min(sh.s - 1, k1 + sh.window - 1) : "
                 "sh.s - 1) / kWgQ;"):
        assert line in dkv, line
    mask = visible_mask(s, window, "cpu")
    block, tile = grid.WGMMA_BLOCK, grid.WGMMA_TILE
    n_tiles = -(-s // tile)

    def sees(q0, nq, k0, nk):
        return bool(mask[q0:q0 + nq, k0:k0 + nk].any())

    for q0 in range(0, s, block):
        want = [kt for kt in range(n_tiles) if sees(q0, block, kt * tile, tile)]
        assert list(grid.wgmma_dq_key_tiles(q0, s, window)) == want, q0
    for k0 in range(0, s, block):
        want = [qt for qt in range(n_tiles) if sees(qt * tile, tile, k0, block)]
        assert list(grid.wgmma_dkv_query_tiles(k0, s, window)) == want, k0


@pytest.mark.parametrize("d", MMA_SYNC_DIMS)
@pytest.mark.parametrize("kernel", ["dq", "dkv"])
def test_tf32_backward_layouts_fit_a_block(kernel, d):
    """``dq_tf32_smem<D>`` (Q and dO of the block's 128 rows resident as
    f32, the K and V tiles as they land, their (hi, lo) pairs) and
    ``dkv_tf32_smem<D>`` (K and V of the block's 128 keys resident, 64 at D
    = 128, the Q and dO tiles as they land with their LSE and delta rows,
    those rows as multiplied, at D = 128 each warp pair's P^T, the pairs),
    computed from the source's
    own constants and lines, fit the 232,448 bytes of shared memory a block
    may take on Hopper, and the source asserts it too."""
    src = flash_ops.SOURCE.read_text()
    for line in (f"constexpr int kDqRows = {grid.TF32_DQ_ROWS};",
                 "constexpr int kTcThreads = 256;  // 8 warps",
                 "__host__ __device__ constexpr int dq_tile() {\n  return D == 128 ? 32 : 64;",
                 "__host__ __device__ constexpr bool dkv_pairs() {\n  return D == 128;",
                 "__host__ __device__ constexpr int dkv_keys() {\n  return dkv_pairs<D>() ? 64 : 128;",
                 "__host__ __device__ constexpr int dkv_tile() {\n  return 32;",
                 "  return D % 32 == 0 ? D : D + 4;",
                 "constexpr size_t kMaxSmem = 232448;"):
        assert line in src, line
    raw_ld = d if d % 32 == 0 else d + 4
    if kernel == "dq":
        tile = grid.tf32_dq_tile(d)
        assert ("  return sizeof(float) * (2 * kDqRows * raw_ld<D>() + 2 * dq_tile<D>() * D) +\n"
                "         sizeof(uint2) * 2 * dq_tile<D>() * (D + 4);") in src
        total = 4 * (2 * grid.TF32_DQ_ROWS * raw_ld + 2 * tile * d) + 8 * 2 * tile * (d + 4)
    else:
        tile = grid.TF32_DKV_TILE
        assert ("  return sizeof(float) * (2 * dkv_keys<D>() * raw_ld<D>() + 2 * dkv_tile<D>() * D +\n"
                "                          4 * dkv_tile<D>() + (dkv_pairs<D>() ? dkv_keys<D>() * "
                "dkv_tile<D>() : 0)) +\n"
                "         sizeof(uint2) * 2 * dkv_tile<D>() * (D + 4);") in src
        keys = grid.tf32_dkv_keys(d)
        total = (4 * (2 * keys * raw_ld + 2 * tile * d + 4 * tile
                      + (keys * tile if d == 128 else 0)) + 8 * 2 * tile * (d + 4))
    assert f"{kernel}_tf32_smem<{d}>() <= kMaxSmem" in src
    assert total <= 232448, (kernel, d, total)


@pytest.mark.parametrize("d", MMA_SYNC_DIMS)
@pytest.mark.parametrize("s,window", [(2048, 512), (2048, None), (100, 16), (64, 1), (40, 16),
                                      (200, 300), (1040, 512), (1100, None), (1100, 512)])
def test_tf32_tile_ranges_and_warp_skips_cover_exactly_the_visible_pairs(s, window, d):
    """The f32 kernels' tile ranges and warp skips (mirrored in grid.py, the
    source's lines asserted): each K6 block (128 queries) visits exactly
    the key tiles holding a pair it sees, and each of its warps (16 rows)
    multiplies exactly the tiles holding a pair its rows see; the same for
    each K7 block (128 keys; 64 at D = 128) over the query tiles and its
    warps' (at D = 128 warp pairs') 16 keys."""
    src = flash_ops.SOURCE.read_text()
    dq = _body(src, "dq_tf32_kernel(const float* __restrict__ q")
    for line in ("const int kt_first = sh.window > 0 ? max(0, q0 - sh.window + 1) / BK : 0;",
                 "const int kt_last = (min(q0 + kDqRows, sh.s) - 1) / BK;",
                 "if (qw < sh.s && k0 <= qw + 15 &&",
                 "(sh.window <= 0 || k0 + BK - 1 >= qw - sh.window + 1)) {"):
        assert line in dq, line
    dkv = _body(src, "dkv_tf32_kernel(const float* __restrict__ q")
    for line in ("const int k1 = min(k0 + kKeys, sh.s) - 1;",
                 "const int qt_first = k0 / BQ;",
                 "const int qt_last = (sh.window > 0 ? min(sh.s - 1, k1 + sh.window - 1) : "
                 "sh.s - 1) / BQ;",
                 "if (!(kw < sh.s && q0 < sh.s && q0 + BQ - 1 >= kw &&",
                 "(sh.window <= 0 || q0 <= kw + 15 + sh.window - 1)))"):
        assert line in dkv, line
    mask = visible_mask(s, window, "cpu")
    rows = grid.TF32_WARP_ROWS

    def sees(q0, nq, k0, nk):
        return bool(mask[q0:q0 + nq, k0:k0 + nk].any())

    tile = grid.tf32_dq_tile(d)
    n_tiles = -(-s // tile)
    for q0 in range(0, s, grid.TF32_DQ_ROWS):
        want = [kt for kt in range(n_tiles) if sees(q0, grid.TF32_DQ_ROWS, kt * tile, tile)]
        got = grid.tf32_dq_key_tiles(q0, s, d, window)
        assert list(got) == want, q0
        for qw in range(q0, q0 + grid.TF32_DQ_ROWS, rows):
            for kt in got:
                assert grid.tf32_dq_warp_sees(qw, kt * tile, s, d, window) == sees(
                    qw, rows, kt * tile, tile), (qw, kt)
    tile, keys = grid.TF32_DKV_TILE, grid.tf32_dkv_keys(d)
    n_tiles = -(-s // tile)
    for k0 in range(0, s, keys):
        want = [qt for qt in range(n_tiles) if sees(qt * tile, tile, k0, keys)]
        got = grid.tf32_dkv_query_tiles(k0, s, d, window)
        assert list(got) == want, k0
        for kw in range(k0, k0 + keys, rows):
            for qt in got:
                assert grid.tf32_dkv_warp_sees(kw, qt * tile, s, d, window) == sees(
                    qt * tile, tile, kw, rows), (kw, qt)


@pytest.mark.parametrize("d", flash_ops.TF32_FWD_HEAD_DIMS)
def test_tf32_forward_layout_fits_a_block(d):
    """``fwd_tf32_smem<D>`` (Q of the block's 128 rows resident as f32, the
    K and V tiles as they land, their (hi, lo) pairs), computed from the
    source's own constants and lines, fits the 232,448 bytes of shared
    memory a block may take on Hopper, and the source asserts it too."""
    src = flash_ops.SOURCE.read_text()
    for line in (f"constexpr int kDqRows = {grid.TF32_DQ_ROWS};",
                 "__host__ __device__ constexpr int dq_tile() {\n  return D == 128 ? 32 : 64;",
                 "  return D % 32 == 0 ? D : D + 4;",
                 "  return sizeof(float) * (kDqRows * raw_ld<D>() + 2 * dq_tile<D>() * D) +\n"
                 "         sizeof(uint2) * 2 * dq_tile<D>() * (D + 4);",
                 f"fwd_tf32_smem<{d}>() <= kMaxSmem",
                 "constexpr size_t kMaxSmem = 232448;"):
        assert line in src, line
    body = _body(src, "fwd_tf32_kernel(const float* __restrict__ q")
    for line in ("constexpr int BK = dq_tile<D>(), NK = BK / 8, NC = D / 8;",
                 "float* land = Qs + kDqRows * raw_ld<D>();",
                 "uint2* Kp = reinterpret_cast<uint2*>(land + 2 * BK * D);",
                 "uint2* Vp = Kp + BK * (D + 4);"):
        assert line in body, line
    raw_ld = d if d % 32 == 0 else d + 4
    tile = grid.tf32_dq_tile(d)
    total = 4 * (grid.TF32_DQ_ROWS * raw_ld + 2 * tile * d) + 8 * 2 * tile * (d + 4)
    assert total <= 232448, (d, total)


@pytest.mark.parametrize("d", flash_ops.TF32_FWD_HEAD_DIMS)
@pytest.mark.parametrize("s,window", [(2048, 512), (2048, None), (100, 16), (64, 1), (40, 16),
                                      (200, 300), (1040, 512), (1100, None), (1100, 512)])
def test_tf32_forward_tile_ranges_and_warp_skips_cover_exactly_the_visible_pairs(s, window, d):
    """fwd_tf32_kernel's key-tile range and warp skip (K6's, on absolute
    positions: ``grid.tf32_fwd_key_tiles``, ``tf32_dq_warp_sees``; the
    source's lines asserted): each block (128 queries) visits exactly
    the key tiles holding a pair it sees, and each of its warps (16 rows)
    multiplies exactly the tiles holding a pair its rows see; at a query
    offset too (a rank holding the rest of the sequence, and one holding
    256 queries of it), on absolute positions."""
    src = flash_ops.SOURCE.read_text()
    body = _body(src, "fwd_tf32_kernel(const float* __restrict__ q")
    for line in ("const int lq0 = (gridDim.y - 1 - blockIdx.y) * kDqRows;",
                 "const int q0 = sh.q0 + lq0, q_end = sh.q0 + sh.sq;",
                 "const int kt_first = sh.window > 0 ? max(0, q0 - sh.window + 1) / BK : 0;",
                 "const int kt_last = (min(q0 + kDqRows, q_end) - 1) / BK;",
                 "if (qw < q_end && k0 <= qw + 15 &&",
                 "(sh.window <= 0 || k0 + BK - 1 >= qw - sh.window + 1)) {"):
        assert line in body, line
    rows, block, tile = grid.TF32_WARP_ROWS, grid.TF32_DQ_ROWS, grid.tf32_dq_tile(d)
    n_tiles = -(-s // tile)
    launches = [(0, s)] + [(q0, sq) for q0 in range(block, s, 2 * block)
                           for sq in dict.fromkeys((s - q0, min(2 * block, s - q0)))]
    for q0, sq in launches:
        mask = visible_mask(s, window, "cpu", q0, sq)  # rows local, keys absolute

        def sees(r0, nr, k0, nk):
            return bool(mask[r0:r0 + nr, k0:k0 + nk].any())

        for r0 in range(0, sq, block):
            want = [kt for kt in range(n_tiles) if sees(r0, block, kt * tile, tile)]
            got = grid.tf32_fwd_key_tiles(r0, s, d, window, q0, sq)
            assert list(got) == want, (q0, sq, r0)
            for lw in range(r0, r0 + block, rows):
                for kt in got:
                    assert grid.tf32_dq_warp_sees(q0 + lw, kt * tile, q0 + sq, d, window) == sees(
                        lw, rows, kt * tile, tile), (q0, sq, lw, kt)
