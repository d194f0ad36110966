"""Tensor-parallel serving of the dense archs (``models/parallel.py``, the
``tp`` of ``models/transformer.py`` and ``launch/steps.py``) on gloo worlds
of 2 (``pods:1x1x2``), 4 (``pods:1x2x2``) and 8 (``pods:2x2x2``) ranks,
one process a rank (``tests/torch_dist_workers.py``), one spawn a world.

Every rank's prefill logits (the prefill step's, whole; and
``prefill_with_caches``'s, its data rank's rows) and 8 decode steps'
logits, teacher-forced on the reference's greedy tokens, are held at
rtol = atol = 1e-5 in f32 against:

- the port's whole-model forward on the same params and tokens; and
- ``repro``'s own partitioned steps: ``make_prefill_step`` /
  ``make_serve_step`` (with ``prefill_with_caches`` / ``decode_step`` for
  the caches and each step's logits) under ``jax.jit`` with
  ``NamedSharding``s from its sharding rules, on a forced 4-device CPU
  (data 2 x model 2), run once in a subprocess
  (``tests/tp_serve_reference.py``), whose params and prompts the ranks
  carry across with ``params_from_jax``.

The serve step's greedy tokens equal ``repro``'s exactly.  The cases
(``torch_dist_workers.TP_CASES``): gemma3-1b (``wq`` split on heads,
``wk``/``wv`` on ``head_dim``: K5 at G = 2), the same with windows of 8
over 20 slots (the ring buffers wrap, 4 slots a rank), with one query
and one KV head (every projection on ``head_dim``), gemma2-9b with
windows of 8 (softcaps) and granite-3-2b.

Also: each rank's plan splits exactly the dims ``repro``'s
``_param_rule`` / ``_cache_rule`` name, for all ten archs at m = 1, 2, 4
and 16, and the ranks' slices tile every leaf; ``vocab_argmax`` breaks
ties as ``argmax`` on the whole logits; every arch serves tensor-parallel
(the other archs' serving is ``tests/test_torch_tp_serve_archs.py``'s),
and a ``tp`` forward under autograd refuses; and each planted fault of ``torch_dist_workers.tp_faults`` (the
row-parallel all-reduce dropped, decode's owner write skipped, its slot
combine without the rescale, the argmax's slice offset dropped) fails the
check at world 2.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_dist_workers import (TP_CAPACITY, TP_CASES, TP_FAULT_CASE, TP_T, TPA_CASES, spawn,
                                tp_batch, tp_config, tp_faults, tp_serve, tp_whole)

from repro.launch import sharding as j_sh
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.launch import steps
from repro_torch.launch.sharding import rank_plan
from repro_torch.models import parallel
from repro_torch.models import transformer as tf
from repro_torch.utils.pytree import tree_flatten_with_path, tree_leaves
from repro_torch.weights import cut

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)
MESHES = {2: "pods:1x1x2", 4: "pods:1x2x2", 8: "pods:2x2x2"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ref_path(tmp_path_factory):
    """``repro``'s partitioned steps on 4 forced CPU devices, pickled."""
    path = tmp_path_factory.mktemp("tp_ref") / "ref.pkl"
    env = {**os.environ, "PYTHONPATH": f"{ROOT / 'src'}{os.pathsep}{ROOT / 'tests'}",
           "JAX_PLATFORMS": "cpu", "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, str(ROOT / "tests" / "tp_serve_reference.py"),
                          str(path)], env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return path


@pytest.fixture(scope="module")
def ref(ref_path):
    with open(ref_path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def whole(ref):
    """The port's whole-model outputs on the reference's params and
    inputs: the prefill step's logits, ``prefill_with_caches``'s and each
    decode step's (teacher-forced on the reference's inputs)."""
    return tp_whole(ref, "dense")


def _world(n):
    @pytest.fixture(scope="module")
    def world(ref_path):
        # the planted faults run on the smallest world only
        return spawn(tp_serve, n, {"mesh": MESHES[n], "ref": str(ref_path), "faults": n == 2})
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


@pytest.mark.parametrize("case", list(TP_CASES))
@pytest.mark.parametrize("n", [2, 4, 8])
def test_tp_serving_matches_the_whole_model(request, n, case, whole):
    for r in _ranks(request, n):
        got = r["cases"][case]
        _held(got, whole[case], got["rows"])


@pytest.mark.parametrize("case", list(TP_CASES))
@pytest.mark.parametrize("n", [2, 4, 8])
def test_tp_serving_matches_repro_s_partitioned_steps(request, n, case, ref):
    want = ref[case]
    for r in _ranks(request, n):
        got = r["cases"][case]
        _held(got, want, got["rows"])
        # greedy tokens: the serve step's, whole, equal repro's exactly
        for t in range(TP_T):
            np.testing.assert_array_equal(got["serve"][t], want["serve"][t])
            np.testing.assert_array_equal(want["serve"][t], want["decode"][t].argmax(-1))


@pytest.mark.parametrize("n", [2, 4, 8])
def test_tp_steps_make_their_collectives(request, n):
    """Each rank's steps gather and all-reduce over its groups; ranks of
    one pod with the same coordinates in other pods count the same."""
    ranks = _ranks(request, n)
    for case in TP_CASES:
        census = [r["cases"][case]["census"] for r in ranks]
        for c in census:
            assert c["prefill_step"]["all-reduce"]["count"] > 0
            assert c["prefill_step"]["all-gather"]["count"] > 0
            assert c["serve_step"]["all-gather"]["count"] > 0
        assert all(c == census[0] for c in census), case


@pytest.mark.parametrize("n", [2, 4, 8])
def test_vocab_argmax_breaks_ties_as_argmax(request, n):
    for r in _ranks(request, n):
        got, want = r["argmax"]
        assert got == want


@pytest.mark.parametrize("fault", list(tp_faults()))
def test_planted_faults_fail_the_check(request, fault, whole):
    """Each planted fault, served on ``pods:1x1x2``, fails what
    ``test_tp_serving_matches_the_whole_model`` holds (its logits) or the
    serve step's greedy tokens (the argmax's), on some rank."""
    want = whole[TP_FAULT_CASE]
    caught = False
    for r in _ranks(request, 2):
        got = r["faults"][fault]
        try:
            _held(got, want, got["rows"])
        except AssertionError:
            caught = True
        # one data rank: the serve step's tokens are the whole batch's
        caught |= any(not np.array_equal(g, w.argmax(-1))
                      for g, w in zip(got["serve"], want["decode"]))
    assert caught, fault
    # the sound run of the same case passes both
    for r in _ranks(request, 2):
        got = r["cases"][TP_FAULT_CASE]
        _held(got, want, got["rows"])
        for g, w in zip(got["serve"], want["decode"]):
            np.testing.assert_array_equal(g, w.argmax(-1))


def _names(path):
    return [str(k) for _, k in path]


@pytest.mark.parametrize("m", [1, 2, 4, 16])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_plan_splits_the_dims_repro_s_rules_name(arch, m):
    """Full width, on meta: each leaf's cut dims are those ``repro``'s
    ``_param_rule`` / ``_cache_rule`` shard (the stacked n_rep axis never),
    each a 1/m (or 1/d) share at the rank's offset."""
    cfg = get_config(arch)
    params = steps.abstract_params(cfg)
    caches = steps.abstract_caches(cfg, 32, 4096)
    d, rank = 2, m - 1
    for kind, tree, rule in (
            ("params", params, lambda names, shape: j_sh._param_rule(names, shape, m)),
            ("caches", caches, lambda names, shape: j_sh._cache_rule(names, shape, d, m))):
        plan = tree_leaves(rank_plan(tree, kind, d, m, 1, rank))
        for (path, x), p in zip(tree_flatten_with_path(tree), plan):
            names = _names(path)
            lead = 1 if names[0] == "pattern" else 0
            spec = (None,) * lead + tuple(rule(names, tuple(x.shape[lead:])))
            want = {i: ax for i, ax in enumerate(spec) if ax is not None and
                    {"model": m, "data": d}[ax] > 1}
            assert {dim for dim, _ in p.cuts} == set(want), (names, spec, p)
            for dim, sl in p.cuts:
                size = {"model": m, "data": d}[want[dim]]
                at = {"model": rank, "data": 1}[want[dim]]
                w = x.shape[dim] // size
                assert (sl.start, sl.stop) == (at * w, (at + 1) * w), (names, dim)


@pytest.mark.parametrize("case", ["gemma3-1b/wrap", "granite-3-2b", "granite-moe",
                                  "mamba2-2.7b", "musicgen-large"])
def test_rank_slices_tile_every_leaf(case):
    """The 2 x 2 ranks' cuts of the params and of a prefill's caches put
    back together are the whole trees, bit for bit (the MoE's experts, the
    SSM's projections, conv and state, the codebook tables and heads, the
    int8 cache's values and scales)."""
    cfg = tp_config(get_config, *{**TP_CASES, **TPA_CASES}[case])
    params = tf.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in tp_batch(cfg, 1).items()}
    _, caches = tf.prefill_with_caches(params, cfg, batch, capacity=TP_CAPACITY)
    for kind, tree in (("params", params), ("caches", caches)):
        parts = {(dr, mr): cut(tree, rank_plan(tree, kind, 2, 2, dr, mr))
                 for dr in range(2) for mr in range(2)}
        for i, x in enumerate(tree_leaves(tree)):
            back = torch.zeros_like(x)
            plan = [tree_leaves(rank_plan(tree, kind, 2, 2, dr, mr))[i] for dr, mr in parts]
            for p, part in zip(plan, parts.values()):
                view = back
                for dim, sl in p.cuts:
                    view = view.narrow(dim, sl.start, sl.stop - sl.start)
                view.copy_(tree_leaves(part)[i])
            assert torch.equal(back, x), (kind, i)


@pytest.mark.parametrize("arch", [*ARCH_NAMES, "under autograd"])
def test_every_arch_serves_tensor_parallel(arch):
    """Every arch takes a ``tp``; a ``tp`` forward under autograd is
    refused (the collectives have no backward), citing item 16a-iii."""
    if arch != "under autograd":
        assert tf.serves_tensor_parallel(get_config(arch))
        return
    cfg = get_config("granite-moe-1b-a400m", reduced=True)
    params = tf.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int32)}
    with pytest.raises(NotImplementedError, match="item 16a-iii"):
        tf.forward(params, cfg, batch, tp=parallel.TensorParallel())
    with torch.no_grad():  # serving: the same call runs
        tf.forward(params, cfg, batch, tp=parallel.TensorParallel())
