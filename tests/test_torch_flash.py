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


def _qkv(h, kv, dtype, seed=0):
    rng = np.random.RandomState(seed)
    arrays = (rng.randn(B, S, h, D), rng.randn(B, S, kv, D), rng.randn(B, S, kv, D),
              rng.randn(B, S, h, D))
    return zip(*(_pair(a, dtype) for a in arrays))


@pytest.mark.parametrize("softcap", [None, 50.0])
@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("g", [1, 4])
def test_flash_forward_lse_and_grads_match_repro_interpret(g, window, softcap):
    """Forward, LSE and (dq, dk, dv); at window 16 with 16-blocks the Pallas
    grid is pruned (3 of 4 k-blocks per q row)."""
    h, kv = 4, 4 // g
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _qkv(h, kv, "float32")
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
                                  "flash_bwd_dkv_sum": 0}


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


@pytest.mark.parametrize("s,window", [(2048, 512), (2048, None), (100, 16), (64, 1), (200, 300),
                                      (1000, 512), (1000, None), (40, 16), (300, 1)])
def test_sm90_tile_ranges_visit_exactly_the_tiles_with_visible_pairs(s, window):
    """The tile ranges of flash_gqa_sm90.cu (mirrored in grid.py): every
    visible (query, key) pair lies in a visited tile, and no visited tile
    is fully masked -- for each K5 and K6 block (128 rows; 64- and 32-key
    tiles), each of its warpgroups (64 rows), and each K7 key tile (64
    keys)."""
    src = flash_ops.SM90_SOURCE.read_text()
    assert f"constexpr int kTile = {grid.SM90_TILE};" in src
    assert f"constexpr int kDqKeys = {grid.SM90_DQ_KEYS};" in src
    mask = visible_mask(s, window, "cpu")
    t = grid.SM90_TILE
    pad = -s % t
    tiles = torch.nn.functional.pad(mask, (0, pad, 0, pad)).reshape(
        (s + pad) // t, t, (s + pad) // t, t).any(3).any(1)  # (query tile, key tile)

    def key_tiles(q0, rows, keys):
        hit = mask[q0:q0 + rows].any(0)
        return sorted({j // keys for j in hit.nonzero().flatten().tolist()})

    rows = grid.SM90_FWD_ROWS
    for tiles_of, keys in ((grid.sm90_fwd_key_tiles, t),
                           (grid.sm90_dq_key_tiles, grid.SM90_DQ_KEYS)):
        for q0 in range(0, s, rows):
            assert list(tiles_of(q0, rows, s, window)) == key_tiles(q0, rows, keys), q0
            for r0 in (q0, q0 + rows // 2):
                want = key_tiles(r0, rows // 2, keys)
                assert list(tiles_of(r0, rows // 2, s, window)) == want, (keys, r0)
    for kt in range(tiles.shape[1]):
        want = tiles[:, kt].nonzero().flatten().tolist()
        assert list(grid.sm90_dkv_query_tiles(kt, s, window)) == want, kt


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
