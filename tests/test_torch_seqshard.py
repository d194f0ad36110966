"""Sequence-parallel prefill (``repro``'s ``seqshard`` variant: ``cfg.seq_shard``
under a ``TensorParallel``, ``models/transformer.py``) and K5 at a query
offset, against ``repro``.

- K5's plain version at a query offset (q0, Sq) equals rows q0 .. q0 + Sq
  - 1 of the whole plain output and of ``repro``'s ``flash_gqa_ref`` at
  1e-6 (windows below and above S/m, softcap); the mask, the pair count,
  the tensor-core kernel's key-tile ranges and the cost at an offset; the
  kernel path refuses an offset off the query tile, records one launch at
  the rank's cost at every head dim, and a backward through an offset
  forward raises.
- The SSD scan from an entering state (``ssd_chunked``'s ``h0``): zeros are
  bitwise no state, and the second half of a sequence from the first
  half's final state is the whole scan's rows.
- The prefill's logits on gloo worlds of model 2 (``pods:1x1x2``), model 4
  (``pods:1x1x4``) and data 2 x model 2 (``pods:1x2x2``), one process a
  rank (``tests/torch_dist_workers.py``), at rtol = atol = 1e-5 in f32
  against ``repro``'s own seqshard step (``make_prefill_step`` under
  ``jax.jit`` with ``_strip_model_axis``'s params, on 4 forced CPU devices,
  run in a subprocess: ``tests/seqshard_reference.py``) and against the
  port's one-rank prefill, for every arch (``torch_dist_workers.SQ_CASES``:
  gemma3-1b with windows of 512 and of 8, gemma2-9b with softcaps,
  granite-3-2b, granite-3-8b, granite-moe with a split and a whole
  ``embed`` and at the two capacity dispatches dropping slots, olmoe,
  mamba2 with several SSD chunks a rank and with S/m < w - 1 (the conv
  halo spans two ranks at m = 4), zamba2, internvl2 with its patches over
  two ranks at m = 4, musicgen).  Each rank's census holds the embedding's
  reduce-scatter, the K/V gathers, the SSM's halo and state gathers, the
  dispatches' count gathers, the last position's broadcast and the
  logits' gathers; the plan cuts exactly what ``_strip_model_axis``
  leaves on the model axis.
- Each planted fault of ``torch_dist_workers.sq_faults`` (RoPE on local
  positions, K/V not gathered, K5 at q0 = 0, the scatter in reversed rank
  order, the last position from rank 0, the SSM state not carried, the
  halo zeroed, the state fold in reverse rank order, the patches on the
  wrong ranks, the codebook partials of rank 0 only, the dispatch slot
  positions left local) fails the check at world 2 on its case.
- Every arch and MoE impl runs under ``seq_shard``: none is refused.
"""
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_dist_workers import (SQ_B, SQ_CASES, SQ_S, spawn, sq_config, sq_fault_case,
                                sq_faults, sq_len, sq_prefill)

from repro.kernels.flash_gqa.ref import flash_gqa_ref as j_flash_gqa_ref
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs.base import InputShape
from repro_torch.kernels import costs
from repro_torch.kernels.flash_gqa import grid
from repro_torch.kernels.flash_gqa import ops as flash_ops
from repro_torch.kernels.flash_gqa.ref import flash_gqa_ref, visible_mask
from repro_torch.launch import steps
from repro_torch.launch.sharding import rank_plan
from repro_torch.models import parallel, ssm
from repro_torch.models import transformer as tf
from repro_torch.utils.pytree import keystr, tree_flatten_with_path
from repro_torch.weights import params_from_jax

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)
MESHES = {"model2": ("pods:1x1x2", 2), "model4": ("pods:1x1x4", 4),
          "data2_model2": ("pods:1x2x2", 4)}
REF_S = 300  # the JAX reference's clock
SHAPE = InputShape("seqshard", SQ_S, SQ_B, "prefill")


def _shape(case):
    return InputShape("seqshard", sq_len(case), SQ_B, "prefill")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- K5 at a query offset ----------------------------------------------------------


def _qkv(b, s, h, kv, d, seed):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d))]


@pytest.mark.parametrize("window,softcap", [(None, None), (3, None), (8, 20.0), (14, None),
                                            (None, 5.0)])
@pytest.mark.parametrize("m", [2, 4])
def test_offset_plain_is_rows_of_the_whole(m, window, softcap):
    """Each rank's (q0, Sq = S/m) queries against keys 0 .. q0 + Sq - 1:
    rows q0 .. q0 + Sq - 1 of the whole plain output and LSE, and of
    ``repro``'s oracle, at 1e-6; windows below S/m (3), above it (8, 14 at
    m = 4) and none."""
    b, s, h, kv, d = 2, 24, 4, 2, 16
    q, k, v = _qkv(b, s, h, kv, d, seed=m)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    kw = dict(window=window, softcap=softcap)
    out, lse = flash_ops.flash_fwd_plain(tq, tk, tv, **kw)
    # repro's oracle takes (B, heads, S, D)
    j_out = np.asarray(j_flash_gqa_ref(*(jnp.asarray(x).transpose(0, 2, 1, 3) for x in (q, k, v)),
                                       **kw)).transpose(0, 2, 1, 3)
    n = s // m
    for r in range(m):
        q0 = r * n
        rows = slice(q0, q0 + n)
        args = (tq[:, rows].contiguous(), tk[:, :q0 + n].contiguous(),
                tv[:, :q0 + n].contiguous())
        got, got_lse = flash_ops.flash_fwd(*args, q0=q0, **kw)  # the CPU's plain version
        np.testing.assert_allclose(got.numpy(), out[:, rows].numpy(), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got_lse.numpy(), lse[:, :, rows].numpy(), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(got.numpy(), j_out[:, rows], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(flash_gqa_ref(*args, q0=q0, **kw).numpy(), j_out[:, rows],
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("s,window", [(1024, 512), (1024, None), (2048, 512), (512, 100),
                                      (4096, 300)])
@pytest.mark.parametrize("m", [2, 4])
def test_offset_mask_pairs_tiles_and_cost(s, window, m):
    """At each rank's offset: the mask is the whole mask's rows, the pair
    count its sum, the key-tile ranges of ``fwd_kernel`` (its blocks of 128
    local rows and their warpgroups of 64) visit exactly the 64-key tiles
    holding visible pairs, and K5's cost counts those pairs, the rank's
    q, out and LSE rows and the k and v rows they can see."""
    whole = visible_mask(s, window, "cpu")
    n = s // m
    t = grid.SM90_TILE
    for r in range(m):
        q0 = r * n
        mask = visible_mask(q0 + n, window, "cpu", q0, n)
        assert torch.equal(mask, whole[q0:q0 + n, :q0 + n])
        pairs = grid.attention_pairs(q0 + n, window, q0, n)
        assert mask.sum().item() == pairs

        def key_tiles(r0, rows):
            hit = mask[r0:r0 + rows].any(0)
            return sorted({j // t for j in hit.nonzero().flatten().tolist()})

        for r0 in range(0, n, grid.SM90_FWD_ROWS):
            for lo, rows in ((r0, 128), (r0, 64), (r0 + 64, 64)):
                got = grid.sm90_fwd_key_tiles(lo, rows, q0 + n, window, q0, n)
                assert list(got) == key_tiles(lo, rows), (r, lo, rows)
        c = costs.flash_fwd_cost(4, q0 + n, 4, 1, 256, window, 2, q0=q0, sq=n)
        assert c["flops"] == 4 * 256 * 4 * 4 * pairs
        keys = q0 + n - (max(0, q0 - window + 1) if window else 0)  # the keys rows can see
        assert keys == mask.any(0).sum().item()
        assert c["bytes"] == (2 * 4 * n * 4 * 256 + 2 * 4 * keys * 256) * 2 + 4 * 4 * n * 4
    # no offset: the launch as before
    assert costs.flash_fwd_cost(2, s, 4, 1, 256, window, 2, q0=0, sq=s) == \
        costs.flash_fwd_cost(2, s, 4, 1, 256, window, 2)


def test_the_kernel_path_refuses_an_offset_off_the_query_tile():
    """On meta (the CUDA path up to the launch) an offset must be a multiple
    of the query tile: refused, not rounded; a multiple records one
    launch at the rank's cost.  Keys must cover the queries, and without
    an offset q and k/v must hold the same positions."""
    from repro_torch.kernels import meta

    q = torch.empty(2, 128, 4, 64, dtype=torch.bfloat16, device="meta")
    k = torch.empty(2, 256, 1, 64, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="multiple of the query tile"):
        flash_ops.flash_fwd(q, k[:, :192], k[:, :192], q0=64)
    with pytest.raises(ValueError, match="do not lie within"):
        flash_ops.flash_fwd(q, k[:, :200], k[:, :200], q0=128)
    # no offset given: q must hold the keys' own positions, on every path
    for dev in ("meta", "cpu"):
        qd, kd = q.to(dev) if dev == "meta" else torch.zeros(2, 128, 4, 64), \
            k if dev == "meta" else torch.zeros(2, 256, 1, 64)
        with pytest.raises(ValueError, match="do not match q"):
            flash_ops.flash_fwd(qd, kd, kd)
        with pytest.raises(ValueError, match="do not match q"):
            flash_ops.flash_gqa(qd, kd, kd)
    with pytest.raises(ValueError, match="no query offset"):
        flash_gqa_ref(torch.zeros(2, 128, 4, 64), torch.zeros(2, 256, 1, 64),
                      torch.zeros(2, 256, 1, 64))
    with meta.census() as c:
        out, lse = flash_ops.flash_fwd(q, k, k, window=100, q0=128)
    assert out.shape == q.shape and lse.shape == (2, 4, 128)
    assert c.launches == {"flash_fwd": 1}
    want = costs.flash_fwd_cost(2, 256, 4, 1, 64, 100, 2, q0=128, sq=128)
    assert (c.flops["flash_fwd"], c.bytes["flash_fwd"]) == (want["flops"], want["bytes"])


def test_reduce_scatter_takes_a_view_in_a_one_rank_gloo_group():
    """``collectives.reduce_scatter`` on gloo (all-reduce, then the slice)
    of a transposed view, along each dim: at one rank the input's values,
    contiguous, one census entry of the result's bytes a call."""
    import torch.distributed as dist

    from repro_torch.launch import collectives

    x = torch.from_numpy(np.random.RandomState(5).randn(4, 8, 6).astype(np.float32))
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        for src in (x, x.transpose(0, 1)):
            for dim in range(3):
                collectives.reset_census()
                got = collectives.reduce_scatter(src, None, dim)
                assert torch.equal(got, src) and got.is_contiguous()
                assert collectives.census() == {
                    "reduce-scatter": {"bytes": got.nbytes, "count": 1}}
    finally:
        collectives.reset_census()
        dist.destroy_process_group()


@pytest.mark.parametrize("d", flash_ops.HEAD_DIMS)
def test_the_offset_launch_is_recorded_at_every_head_dim(d):
    """K5's meta path at a query offset at each head dim the kernels take
    (80 and 128 are zamba2's and internvl2's ranks): its outputs and one
    launch at ``costs.flash_fwd_cost``'s offset cost."""
    from repro_torch.kernels import meta

    b, s, h, kv, n = 4, 1024, 4, 2, 512
    q = torch.empty(b, n, h, d, dtype=torch.bfloat16, device="meta")
    k = torch.empty(b, s, kv, d, dtype=torch.bfloat16, device="meta")
    with meta.census() as c:
        out, lse = flash_ops.flash_fwd(q, k, k, q0=s - n)
    assert out.shape == q.shape and lse.shape == (b, h, n)
    want = costs.flash_fwd_cost(b, s, h, kv, d, None, 2, q0=s - n, sq=n)
    assert c.launches == {"flash_fwd": 1}
    assert (c.flops["flash_fwd"], c.bytes["flash_fwd"]) == (want["flops"], want["bytes"])


def test_a_backward_through_an_offset_forward_raises():
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _qkv(1, 8, 2, 1, 16, seed=0))
    out = flash_ops.flash_gqa(q[:, 4:], k, v, q0=4)
    with pytest.raises(NotImplementedError, match="R7"):
        out.sum().backward()
    flash_ops.flash_gqa(q, k, v).sum().backward()  # no offset: K6 + K7 as before
    assert q.grad is not None


# -- the prefill against repro and the one-rank prefill -------------------------------


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """``repro``'s seqshard steps in a subprocess; yields (the path of its
    inputs, a function returning its outputs), the inputs written before
    it compiles."""
    d = tmp_path_factory.mktemp("sq_ref")
    ins, outs = d / "inputs.pkl", d / "outputs.pkl"
    env = {**os.environ, "PYTHONPATH": f"{ROOT / 'src'}{os.pathsep}{ROOT / 'tests'}",
           "JAX_PLATFORMS": "cpu", "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen([sys.executable, str(ROOT / "tests" / "seqshard_reference.py"),
                             str(ins), str(outs)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    deadline = time.monotonic() + REF_S
    try:
        while not ins.exists():
            assert proc.poll() is None, proc.communicate()[1][-4000:]
            assert time.monotonic() < deadline, "the reference wrote no inputs"
            time.sleep(0.2)

        def outputs():
            _, err = proc.communicate(timeout=max(1.0, deadline - time.monotonic()))
            assert proc.returncode == 0, err[-4000:]
            with open(outs, "rb") as f:
                return pickle.load(f)

        yield str(ins), outputs
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.fixture(scope="module")
def inputs(reference):
    with open(reference[0], "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def repro_out(reference):
    return reference[1]()


def _world(key):
    @pytest.fixture(scope="module")
    def world(reference):
        mesh, n = MESHES[key]
        # the planted faults run on the smallest world only
        return spawn(sq_prefill, n, {"mesh": mesh, "ref": reference[0],
                                     "faults": key == "model2"})
    return world


model2, model4, data2_model2 = _world("model2"), _world("model4"), _world("data2_model2")


@pytest.fixture(scope="module")
def whole(inputs):
    """The port's one-rank prefill step per case (``seq_shard`` off, and on
    with no ``tp``: the same program)."""
    out = {}
    for name in SQ_CASES:
        cfg = sq_config(get_config, name)
        params = params_from_jax(inputs[name]["params"], device="cpu")
        batch = {k: torch.from_numpy(v) for k, v in inputs[name]["prompt"].items()}
        plain = steps.make_prefill_step(cfg.replace(seq_shard=False), _shape(name))(params,
                                                                                   batch)
        assert torch.equal(steps.make_prefill_step(cfg, _shape(name))(params, batch), plain)
        out[name] = plain.numpy()
    return out


@pytest.mark.parametrize("case", list(SQ_CASES))
@pytest.mark.parametrize("key", list(MESHES))
def test_seqshard_prefill_matches_repro_and_the_one_rank_prefill(request, key, case, whole,
                                                                 repro_out):
    want = repro_out["logits"][case]
    np.testing.assert_allclose(whole[case], want, **TOL)
    for r in request.getfixturevalue(key):
        got = r["cases"][case]["logits"]
        cfg = sq_config(get_config, case)
        codebooks = (cfg.n_codebooks,) if cfg.frontend == "audio_codebooks" else ()
        assert got.shape == (SQ_B, 1, *codebooks, cfg.vocab_size)
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(got, whole[case], **TOL)


@pytest.mark.parametrize("key", list(MESHES))
def test_each_rank_makes_the_sequence_parallel_collectives(request, key):
    """Per rank: one reduce-scatter where ``embed`` splits over the vocab
    (none where it is whole), a K and a V gather an attention layer, a conv
    halo and a state gather an SSM layer, a count gather a capacity MoE
    layer (and at data 2 the ``dispatch``'s data gather), the logits' vocab
    and data gathers, one broadcast of the last position; every rank
    counts the same."""
    mesh, n = MESHES[key]
    m, data = (n, 1) if key != "data2_model2" else (2, 2)
    ranks = request.getfixturevalue(key)
    for case in SQ_CASES:
        cfg = sq_config(get_config, case)
        kinds = [spec.kind for spec in cfg.layers]
        n_ssm, n_moe = kinds.count("ssm"), kinds.count("moe")
        dispatch = n_moe if cfg.moe_impl in ("dispatch", "dispatch_grouped") else 0
        split = cfg.vocab_size % m == 0
        census = [r["cases"][case]["census"] for r in ranks]
        assert all(c == census[0] for c in census), case
        c = census[0]
        data_gathers = dispatch if cfg.moe_impl == "dispatch" and data > 1 else 0
        assert c["all-gather"]["count"] == (2 * (len(kinds) - n_ssm) + split + (data > 1)
                                            + data_gathers), case
        for name, count in (("conv-halo", n_ssm), ("ssm-state", n_ssm),
                            ("moe-counts", dispatch)):
            assert c.get(f"all-gather:{name}", {"count": 0})["count"] == count, (case, name)
        assert c["collective-broadcast"]["count"] == 1
        assert ("reduce-scatter" in c) == split, case
        if split:
            rows = SQ_B // data
            assert c["reduce-scatter"] == {"count": 1, "bytes": rows * sq_len(case) // m
                                           * cfg.d_model * 4}
        assert "all-reduce" not in c, case


def test_the_plan_cuts_what_strip_model_axis_leaves_on_model(model2, repro_out):
    """Full width, every arch, m = 2, 4, 16: ``rank_plan(seqshard=True)``
    cuts exactly the leaves ``repro``'s ``_strip_model_axis`` keeps on the
    model axis (``embed`` / ``heads`` where the vocab divides), and the
    ranks' plans cut ``embed`` (and musicgen's ``heads``) only in the
    reduced cases where the vocab splits."""
    for arch in ARCH_NAMES:
        params = steps.abstract_params(get_config(arch))
        for m in (2, 4, 16):
            stripped = repro_out["stripped"][arch][m]
            plan = rank_plan(params, "params", 1, m, 0, m - 1, seqshard=True)
            for (path, p), (_, x) in zip(tree_flatten_with_path(plan),
                                         tree_flatten_with_path(params)):
                spec = stripped[keystr(path).replace("/", "")]
                want = {i for i, ax in enumerate(spec) if ax == "model"}
                assert {d for d, _ in p.cuts} == want, (arch, m, keystr(path), spec)
                assert not want or keystr(path).startswith(("['embed']", "['heads']"))
    for case, got in model2[0]["cases"].items():
        want = [] if case == "granite-moe/odd_vocab" else ["['embed']"]
        if case == "musicgen-large":  # and the codebook heads
            want.append("['heads']")
        assert got["cut"] == want, case


@pytest.mark.parametrize("fault", list(sq_faults()))
def test_planted_faults_fail_the_check(model2, fault, whole, repro_out):
    case = sq_fault_case(fault)
    want = repro_out["logits"][case]
    for r in model2:  # the sound run passes
        np.testing.assert_allclose(r["cases"][case]["logits"], want, **TOL)
    caught = False
    for r in model2:
        try:
            np.testing.assert_allclose(r["faults"][fault], want, **TOL)
        except AssertionError:
            caught = True
    assert caught, fault


# -- what seq_shard takes -----------------------------------------------------------


@pytest.mark.parametrize("arch,impl", [("mamba2-2.7b", None), ("zamba2-2.7b", None),
                                       ("internvl2-2b", None), ("musicgen-large", None),
                                       ("granite-moe-1b-a400m", "dispatch"),
                                       ("olmoe-1b-7b", "dispatch_grouped")])
def test_item_16b_ii_archs_are_refused(arch, impl):
    """The archs ROADMAP.md item 16b-ii once refused (the SSM, hybrid and
    frontend archs, the capacity MoE impls) are refused no more: the
    prefill step is made under ``seq_shard``, and ``forward`` under a
    ``tp`` reaches the sequence-parallel program (whose first check is
    that autograd is off), never the tensor-parallel one."""
    cfg = get_config(arch, reduced=True).replace(seq_shard=True)
    if impl:
        cfg = cfg.replace(moe_impl=impl)
    tf.check_seq_shard(cfg)
    steps.make_prefill_step(cfg, SHAPE)
    tp = parallel.TensorParallel(size=2)
    with pytest.raises(NotImplementedError, match="R7"):
        tf.forward({}, cfg, {}, tp=tp)


def test_check_seq_shard_refuses_a_config_without_a_decoder_stack():
    from repro_torch.configs.resnet_cifar import SMALL_CNN

    with pytest.raises(NotImplementedError, match="no decoder stack"):
        tf.check_seq_shard(SMALL_CNN)


# -- the SSD scan from an entering state ---------------------------------------------


def _ssd_inputs(seed, b=2, s=16, h=3, p=4, n=5):
    rng = np.random.RandomState(seed)
    xh, bm, cm = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
                  for shape in ((b, s, h, p), (b, s, n), (b, s, n)))
    dt = torch.nn.functional.softplus(torch.from_numpy(rng.randn(b, s, h).astype(np.float32)))
    a = -torch.from_numpy(rng.uniform(0.5, 2.0, h).astype(np.float32))
    return xh, bm, cm, dt, a


@pytest.mark.parametrize("chunk", [4, 16])
def test_ssd_from_an_entering_state_continues_the_scan(chunk):
    """Zeros as ``h0`` are bitwise no ``h0``; the second half from the first
    half's final state is the whole scan's second half (and its final
    state) at 1e-5; a callable ``h0`` gets the final state from zeros and
    the total log-decay sum(dt A), and its result is the entering state."""
    cfg = get_config("mamba2-2.7b", reduced=True).replace(ssm_chunk=chunk)
    xh, bm, cm, dt, a = _ssd_inputs(chunk)
    y, h = ssm.ssd_chunked(cfg, xh, bm, cm, dt, a)
    y0, h0 = ssm.ssd_chunked(cfg, xh, bm, cm, dt, a, torch.zeros_like(h))
    assert torch.equal(y, y0) and torch.equal(h, h0)
    half = slice(0, 8), slice(8, 16)
    y1, h1 = ssm.ssd_chunked(cfg, *(x[:, half[0]] for x in (xh, bm, cm, dt)), a)
    seen = {}

    def enter(h_zero, log_decay):
        seen["h"], seen["a"] = h_zero, log_decay
        return h1

    y2, h2 = ssm.ssd_chunked(cfg, *(x[:, half[1]] for x in (xh, bm, cm, dt)), a, enter)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y.numpy(), **TOL)
    np.testing.assert_allclose(h2.numpy(), h.numpy(), **TOL)
    alone = ssm.ssd_chunked(cfg, *(x[:, half[1]] for x in (xh, bm, cm, dt)), a)[1]
    assert torch.equal(seen["h"], alone)
    np.testing.assert_allclose(seen["a"].numpy(), (dt[:, half[1]] * a).sum(1).numpy(), **TOL)
    # the fold of two halves' states is the whole final state
    np.testing.assert_allclose((h1 * torch.exp(seen["a"])[..., None, None] + alone).numpy(),
                               h.numpy(), **TOL)


def test_seq_shard_runs_forward_only():
    """No backward (R7): the forward refuses autograd, the cache prefill and
    the tensor-parallel train step refuse the flag."""
    cfg = sq_config(get_config, "gemma3-1b")
    tp = parallel.TensorParallel(size=2)
    with pytest.raises(NotImplementedError, match="R7"):
        tf.forward({}, cfg, {}, tp=tp)
    with torch.no_grad(), pytest.raises(NotImplementedError, match="no decode caches"):
        tf.prefill_with_caches({}, cfg, {}, tp=tp)
    with pytest.raises(NotImplementedError, match="R7"):
        steps.make_train_step(cfg, InputShape("t", SQ_S, 2, "train"), tp=tp)
