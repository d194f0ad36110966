"""The pfedsop_update kernel pair (K1 reduce, K2 update) against ``repro``.

On the CPU the wrappers run their plain PyTorch versions (a CUDA kernel
has no interpreter); ``chip_smoke.py`` holds the CUDA kernels against
these plain versions on the card.  The reference here is ``repro``'s
Pallas kernels run in interpret mode, as its own tests run them.

Tolerances: f32 sums over N <= 40,007 taken in another order (torch's
vectorised tile sums against Pallas' (rows, 128) tiles) -> beta and the
three sums to rtol 1e-5; x_new to rtol 1e-5 in f32, and to one bf16 ulp
(rtol 2**-7) in bf16, where an f32 value a few ulps from a rounding
boundary may round the other way.
"""
import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.pfedsop_update import ops as j_ops
from repro.kernels.pfedsop_update.kernel import reduce3_batched_pallas
from repro_torch.kernels.pfedsop_update import ops
from repro_torch.kernels.pfedsop_update.ref import pfedsop_update_batched_ref

# (C, N, shared d_g, dtype): every value of each axis, and its pairings
CASES = [
    (1, 1000, True, "float32"),
    (3, 1000, False, "bfloat16"),
    (3, 19930, True, "float32"),
    (1, 19930, False, "bfloat16"),
    (3, 19930, False, "float32"),
    (3, 40007, True, "bfloat16"),
    (3, 40007, False, "float32"),
    (1, 40007, True, "float32"),
]
HP = dict(eta1=0.05, rho=1.3, lam=0.8)


def _operands(c, n, shared, dtype, seed=0):
    rng = np.random.RandomState(seed)
    dg = rng.randn(n) if shared else rng.randn(c, n)
    mix = np.linspace(-1.0, 1.0, c)[:, None]
    di = 0.3 * (mix * dg + rng.randn(c, n))
    x = rng.randn(c, n)
    jd = getattr(jnp, dtype)
    jax_ops = [jnp.asarray(a.astype(np.float32)).astype(jd) for a in (x, di, dg)]
    td = getattr(torch, dtype)
    torch_ops = [torch.from_numpy(a.astype(np.float32)).to(td) for a in (x, di, dg)]
    return jax_ops, torch_ops


def _as_f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("c,n,shared,dtype", CASES)
def test_update_pair_matches_repro_interpret(c, n, shared, dtype):
    (jx, jdi, jdg), (tx, tdi, tdg) = _operands(c, n, shared, dtype)
    want_x, want_b = j_ops.pfedsop_update_batched(jx, jdi, jdg, interpret=True, **HP)
    # K1 alone: the tile partials differ in layout, their sums must agree
    jdg3 = jdg if not shared else jdg[None]
    pad = lambda a: jnp.pad(a, ((0, 0), (0, -n % 128))).reshape(a.shape[0], -1, 128)
    j_sums = np.asarray(reduce3_batched_pallas(pad(jdi), pad(jdg3), interpret=True).sum(1))
    partials = ops.reduce3_batched(tdi, tdg)
    assert partials.shape == (c, ops.n_tiles(n), 3) and partials.dtype == torch.float32
    np.testing.assert_allclose(partials.sum(1).numpy(), j_sums, rtol=1e-5, atol=1e-6)
    # the pair through the wrappers (plain versions on the CPU) and the
    # reference oracle, each against repro's kernel
    rtol = 1e-5 if dtype == "float32" else 2.0 ** -7
    for impl in ("auto", "reference"):
        got_x, got_b = ops.pfedsop_update_batched(tx, tdi, tdg, impl=impl, **HP)
        assert got_x.dtype == tx.dtype and got_b.shape == (c,)
        np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got_x.float().numpy(), _as_f32(want_x), rtol=rtol,
                                   atol=1e-6)


def test_one_client_is_the_c1_launch_of_the_pair():
    """K3 (repro's unbatched reduce3/update kernels) against the C = 1 call."""
    (jx, jdi, jdg), (tx, tdi, tdg) = _operands(1, 19930, True, "float32", seed=4)
    want_x, want_b = j_ops.pfedsop_update(jx[0], jdi[0], jdg, interpret=True, **HP)
    got_x, got_b = ops.pfedsop_update(tx[0], tdi[0], tdg, **HP)
    assert got_x.shape == (19930,) and got_b.shape == ()
    np.testing.assert_allclose(float(got_b), float(want_b), rtol=1e-5)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=1e-5, atol=1e-6)


def test_update_plain_matches_oracle_and_zero_deltas_keep_x():
    """K2's plain version applies the oracle's update given its beta, and
    zero deltas (round 1) hit the cosine guard: beta finite, x unchanged."""
    _, (tx, tdi, tdg) = _operands(3, 1000, True, "float32", seed=2)
    want_x, beta = pfedsop_update_batched_ref(tx, tdi, tdg, eps=1e-12, **HP)
    assert torch.equal(ops.pfedsop_update_batched(tx, tdi, tdg, impl="reference", **HP)[0],
                       want_x)
    zeros = torch.zeros_like(tdi)
    out, b = ops.pfedsop_update_batched(tx, zeros, torch.zeros_like(tdg), **HP)
    assert torch.isfinite(b).all() and torch.equal(out, tx)
    assert ops.LAUNCHES == {"reduce3": 0, "update": 0}  # CPU: no kernel launched


def test_impl_vocabulary():
    _, (tx, tdi, tdg) = _operands(1, 1000, True, "float32")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.pfedsop_update_batched(tx, tdi, tdg, impl="kernel")
    with pytest.raises(ValueError, match="no counterpart"):
        ops.pfedsop_update_batched(tx, tdi, tdg, impl="kernel_interpret")
    with pytest.raises(ValueError, match="unknown impl"):
        ops.pfedsop_update_batched(tx, tdi, tdg, impl="mosaic")


@pytest.mark.parametrize("bad", ["dg_shape", "dtype_mix", "float64", "strided", "scalars"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    _, (tx, tdi, tdg) = _operands(2, 1000, True, "float32")
    beta = ec = torch.full((2,), 0.5)
    if bad == "dg_shape":
        tdg = tdg[:999]
    elif bad == "dtype_mix":
        tdg = tdg.to(torch.bfloat16)
    elif bad == "float64":
        tx, tdi, tdg = tx.double(), tdi.double(), tdg.double()
    elif bad == "strided":
        tdi = torch.cat([tdi, tdi], 1)[:, ::2]
    else:
        beta = torch.full((3,), 0.5)
    with pytest.raises(ValueError):
        ops.update_batched(tx, tdi, tdg, beta, ec)
    if bad != "scalars":
        with pytest.raises(ValueError):
            ops.reduce3_batched(tdi, tdg)


_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "int": ctypes.c_int, "long long": ctypes.c_longlong,
            "const char*": ctypes.c_char_p}


def test_ctypes_signatures_match_the_cuda_source():
    """No compiler here: hold the ctypes declarations to the .cu's C
    interface, parameter by parameter (a pointer declared as an int would
    be cut to 32 bits)."""
    src = ops.SOURCE.read_text()
    for name, (argtypes, restype) in ops.SIGNATURES.items():
        m = re.search(r'extern "C" ([\w ]+\*?) ?' + name + r"\(([^)]*)\)", src)
        assert m, name
        params = [re.sub(r"\s+\w+$", "", p.strip()) for p in m.group(2).split(",")]
        assert [_C_TYPES[p] for p in params] == argtypes, name
        assert _C_TYPES[m.group(1).strip()] is restype, name


def test_kernel_build_is_keyed_by_source_and_needs_nvcc(tmp_path, monkeypatch):
    from repro_torch.kernels import build

    a, b = tmp_path / "a.cu", tmp_path / "b.cu"
    a.write_text("// one")
    b.write_text("// two")
    assert build.library_path(a) != build.library_path(b)
    assert build.library_path(a).parent == build.BUILD_DIR
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setattr(build.os.path, "exists", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build(a)
