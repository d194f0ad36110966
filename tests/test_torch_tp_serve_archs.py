"""Tensor-parallel serving of the MoE, SSM, hybrid and frontend archs
(``models/moe.py``, ``models/ssm.py``, the int8 cache of
``models/attention.py``, the codebooks and the vision path of
``models/transformer.py``, ``models/parallel.py``'s ``sum_f32``,
``rms_noscale`` and ``codebook_embed``) on gloo worlds of 2
(``pods:1x1x2``), 4 (``pods:1x2x2``) and 8 (``pods:2x2x2``) ranks, one
process a rank (``tests/torch_dist_workers.py``), one spawn a world.

The cases (``torch_dist_workers.TPA_CASES``, reduced so that every rule
splits at m = 2 and 4, but one): granite-moe-1b-a400m under each MoE impl
(the dispatches at capacity factor 0.5, so slots are dropped),
olmoe-1b-7b at 8 experts, mamba2-2.7b, mamba2-2.7b at 3 heads
(``in_proj`` and the ``state`` whole, the conv and ``out_proj`` split:
each leaf falls back on its own), zamba2-2.7b with two invocations of
its shared block, internvl2-2b with an odd vocabulary (its ``embed``
whole: ``vocab_embed`` / ``vocab_argmax`` on whole leaves) and
musicgen-large (codebooks, int8 cache).

Every rank's prefill logits (the prefill step's, whole; and
``prefill_with_caches``'s, its data rank's rows) and 8 decode steps'
logits, teacher-forced on the reference's greedy tokens, are held at
rtol = atol = 1e-5 in f32 against the port's whole model on the same
params and inputs, and against ``repro``'s own ``jax.jit``-partitioned
steps on a forced 4-device CPU (data 2 x model 2), run once in a
subprocess (``tests/tp_serve_reference.py archs``); the serve step's
greedy tokens equal ``repro``'s exactly.  The caches a rank's prefill
leaves are the whole model's cut by its plan (the int8 values and scales
bit for bit).  Each planted fault of ``torch_dist_workers.tpa_faults``
fails the check at world 2.  ``launch/serve.py --mesh`` on two ranks gives
the one-process run's tokens.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_dist_workers import (TP_CAPACITY, TP_T, TPA_CASES, leaf_np, serve_cli, spawn,
                                tp_config, tp_serve, tp_whole, tpa_faults)

from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.launch.sharding import rank_plan
from repro_torch.models import attention, parallel
from repro_torch.models import transformer as tf
from repro_torch.utils.pytree import tree_flatten_with_path, tree_leaves
from repro_torch.weights import cut, params_from_jax

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)
MESHES = {2: "pods:1x1x2", 4: "pods:1x2x2", 8: "pods:2x2x2"}
# (data size, model size) of each world's ranks, and (data rank, model rank)
# of rank r: pods:PxDxM lays out model fastest
SIZES = {2: (1, 2), 4: (2, 2), 8: (2, 2)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ref_path(tmp_path_factory):
    """``repro``'s partitioned steps on 4 forced CPU devices, pickled."""
    path = tmp_path_factory.mktemp("tp_ref_archs") / "ref.pkl"
    env = {**os.environ, "PYTHONPATH": f"{ROOT / 'src'}{os.pathsep}{ROOT / 'tests'}",
           "JAX_PLATFORMS": "cpu", "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, str(ROOT / "tests" / "tp_serve_reference.py"),
                          str(path), "archs"], env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return path


@pytest.fixture(scope="module")
def ref(ref_path):
    with open(ref_path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def whole(ref):
    return tp_whole(ref, "archs")


def _world(n):
    @pytest.fixture(scope="module")
    def world(ref_path):
        # the planted faults run on the smallest world only
        return spawn(tp_serve, n, {"mesh": MESHES[n], "ref": str(ref_path), "suite": "archs",
                                   "faults": n == 2})
    return world


world2, world4, world8 = _world(2), _world(4), _world(8)


def _ranks(request, n):
    return request.getfixturevalue(f"world{n}")


def _held(got, want, rows):
    """Every rank's outputs against ``want`` (whole batch) at ``TOL``."""
    lo, hi = rows
    np.testing.assert_allclose(got["prefill_step"], want["prefill_step"], **TOL)
    np.testing.assert_allclose(got["prefill"], want["prefill"][lo:hi], **TOL)
    assert len(got["decode"]) == len(want["decode"]) == TP_T
    for g, w in zip(got["decode"], want["decode"]):
        np.testing.assert_allclose(g, w[lo:hi], **TOL)


@pytest.mark.parametrize("case", list(TPA_CASES))
@pytest.mark.parametrize("n", [2, 4, 8])
def test_tp_serving_matches_the_whole_model(request, n, case, whole):
    for r in _ranks(request, n):
        got = r["cases"][case]
        _held(got, whole[case], got["rows"])


# ROADMAP.md R6: repro's jit-partitioned serve step returns codebook tokens
# that are not the argmax of its own logits (its decode step's, partitioned
# or not, and its serve step unpartitioned); its logits hold.  The serve
# tokens of these cases are held to the argmax of repro's decode logits.
R6 = {"musicgen-large"}


@pytest.mark.parametrize("case", list(TPA_CASES))
@pytest.mark.parametrize("n", [2, 4, 8])
def test_tp_serving_matches_repro_s_partitioned_steps(request, n, case, ref):
    want = ref[case]
    for r in _ranks(request, n):
        got = r["cases"][case]
        _held(got, want, got["rows"])
        for t in range(TP_T):
            greedy = want["decode"][t].argmax(-1)
            np.testing.assert_array_equal(got["serve"][t], greedy)
            if case not in R6:
                np.testing.assert_array_equal(want["serve"][t], greedy)


def _whole_caches(case, ref):
    """The whole model's prefill caches of ``case`` as a tree."""
    cfg = tp_config(get_config, *TPA_CASES[case])
    params = params_from_jax(ref[case]["params"], device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in ref[case]["prompt"].items()}
    return tf.prefill_with_caches(params, cfg, batch, TP_CAPACITY)[1]


@pytest.mark.parametrize("case", list(TPA_CASES))
@pytest.mark.parametrize("n", [2, 4, 8])
def test_prefill_leaves_each_rank_its_cut_of_the_caches(request, n, case, ref, whole):
    """A rank's prefill caches are the whole model's cut by its plan: the
    int8 values and scales bit for bit (quantised per token and head from
    whole heads), the rest at ``TOL``."""
    caches = _whole_caches(case, ref)
    d, m = SIZES[n]
    for rank, r in enumerate(_ranks(request, n)):
        want = cut(caches, rank_plan(caches, "caches", d, m, (rank // m) % d, rank % m))
        got = r["cases"][case]["caches"]
        for (path, w), g in zip(tree_flatten_with_path(want), got):
            assert g.shape == tuple(w.shape), (path, g.shape, w.shape)
            if w.dtype in (torch.int8, torch.int32, torch.bfloat16):
                np.testing.assert_array_equal(g, leaf_np(w), err_msg=str(path))
            else:
                np.testing.assert_allclose(g, leaf_np(w), err_msg=str(path), **TOL)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_tp_steps_make_their_collectives(request, n):
    """Each rank's steps all-reduce over its groups (the MoE's f32 sum,
    the SSM's norm statistic, the row-parallel projections, the codebook
    lookups); ranks of one world count the same."""
    ranks = _ranks(request, n)
    for case in TPA_CASES:
        census = [r["cases"][case]["census"] for r in ranks]
        for c in census:
            assert c["prefill_step"]["all-reduce"]["count"] > 0, case
            assert c["serve_step"]["all-reduce"]["count"] > 0, case
            assert c["serve_step"]["all-gather"]["count"] > 0, case
        assert all(c == census[0] for c in census), case


@pytest.mark.parametrize("fault", list(tpa_faults()))
def test_planted_faults_fail_the_check(request, fault, whole):
    """Each planted fault, served on ``pods:1x1x2``, fails what
    ``test_tp_serving_matches_the_whole_model`` holds on some rank, while
    the sound run of its case passes."""
    case = tpa_faults()[fault][0]
    want = whole[case]
    caught = False
    for r in _ranks(request, 2):
        got = r["faults"][fault]
        try:
            _held(got, want, got["rows"])
        except AssertionError:
            caught = True
    assert caught, fault
    for r in _ranks(request, 2):
        got = r["cases"][case]
        _held(got, want, got["rows"])


@pytest.mark.parametrize("m", [2, 4])
def test_int8_prefill_cache_pieces_are_the_whole_cache(m):
    """``pack_prefill_cache`` of musicgen's int8 cache on each of m slot
    slices (wrapping: 12 prompt positions in 8 slots), put back together,
    is the whole cache bit for bit."""
    cfg = get_config("musicgen-large", reduced=True)
    g = torch.Generator().manual_seed(0)
    k, v = (torch.randn(3, 12, cfg.n_kv_heads, cfg.head_dim, generator=g) for _ in range(2))
    positions = torch.arange(12, dtype=torch.int32)[None].expand(3, 12)
    want = attention.pack_prefill_cache(cfg, k, v, positions, 8, torch.float32)
    parts = [attention.pack_prefill_cache(cfg, k, v, positions, 8, torch.float32,
                                          parallel.TensorParallel(size=m, rank=r))
             for r in range(m)]
    for name in ("k", "v", "k_scale", "v_scale"):
        assert torch.equal(torch.cat([p[name] for p in parts], dim=1), want[name]), name
    for p in parts:
        assert torch.equal(p["pos"], want["pos"])


def test_zamba2_shared_block_is_cut_as_the_plan_says():
    """``params["shared"]`` (one block, no n_rep axis) is cut by the
    attention and MLP rules like any block, at m = 2."""
    cfg = tp_config(get_config, *TPA_CASES["zamba2-2.7b"])
    params = tf.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    plan = rank_plan(params, "params", 1, 2, 0, 1)
    shared = dict(zip((tuple(str(k) for _, k in p) for p, _ in
                       tree_flatten_with_path(params["shared"])),
                      tree_leaves(plan["shared"])))
    h, f = cfg.n_heads, cfg.d_ff
    assert shared[("attn", "wq")].cuts == ((1, slice(h // 2, h)),)
    assert shared[("attn", "wo")].cuts == ((0, slice(h // 2, h)),)
    assert shared[("mlp", "wi_gate")].cuts == ((1, slice(f // 2, f)),)
    assert shared[("mlp", "wo")].cuts == ((0, slice(f // 2, f)),)
    assert shared[("ln1", "scale")].cuts == ()


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mamba2-2.7b"])
def test_serve_cli_on_a_mesh_gives_the_one_process_tokens(arch):
    """``launch/serve.py --mesh pods:1x1x2`` on two gloo ranks: a fed
    prompt and greedy decode give every rank the one-process run's
    tokens."""
    argv = ["--device", "cpu", "--arch", arch, "--prompt-len", "6", "--steps", "6",
            "--capacity", "16"]
    want = serve.main(argv)
    for got in spawn(serve_cli, 2, argv + ["--mesh", "pods:1x1x2"]):
        np.testing.assert_array_equal(got, want)
