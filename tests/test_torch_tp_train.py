"""The tensor-parallel train step (``launch/steps.py::make_train_step(tp=)``
over ``models/parallel.py``'s differentiable collectives) on gloo worlds of
model 2 (``pods:1x1x2``), model 4 (``pods:1x1x4``) and data 2 x model 2
(``pods:1x2x2``), one process a rank (``tests/torch_dist_workers.py``),
one spawn a world.

The cases (``torch_dist_workers.TT_CASES``): the eight text archs,
reduced, in f32, with ``tp_config``'s variants that make every rule split
(gemma3-1b's K/V gathered over ``head_dim``, and every projection on
``head_dim``; the MoE's experts, ``dense`` and ``dispatch``, and 8 of them;
the SSM's cuts, and its leaves whole; zamba2's shared block twice).  One
step (the round start, 2 local steps of batch 2 x 16 tokens, Eq. 13) from
``repro``'s init plus noise, with noise deltas, made whole from the ranks'
slices, is held at rtol = atol = 1e-5 against:

- the port's one-rank step on the same inputs; and
- ``repro``'s own step jit-partitioned as ``repro/launch/train.py``
  partitions it (the state and the global delta sharded over ``model`` by
  its rules) on a forced 4-device CPU (data 2 x model 2), run in a
  subprocess (``tests/tp_train_reference.py``) that writes the inputs the
  ranks carry across with ``params_from_jax`` before it compiles.

At data 2 every data rank takes a gradient chunk of its own (``optim/
sgd.py``'s data split), so the world is held against the steps at
``grad_chunks`` 2 (the MoE's aux loss and capacity are per chunk; the
other archs' chunk mean is the batch's), and bit for bit against the
model-only step at ``grad_chunks`` 2 on each data rank's model group.
Every rank's loss and every replicated leaf of its outputs are bitwise
equal across the ranks; the round start's (beta, eta1 * coeff) on each
rank's slices are the whole tree's within 1e-5.  Each planted fault of
``torch_dist_workers.tt_faults`` fails its check at world 2.  And
``launch/train.py`` under ``torchrun`` on ``--mesh pods:1x1x2`` writes the
one-rank run's checkpoint, whole, within 1e-5.
"""
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_dist_workers import TT_CASES, spawn, tp_train, tt_faults, tt_whole

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)
MESHES = {"model2": ("pods:1x1x2", 2), "model4": ("pods:1x1x4", 4),
          "data2_model2": ("pods:1x2x2", 4)}
REF_S = 300  # the JAX reference's clock


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """``repro``'s jit-partitioned steps in a subprocess; yields (the path
    of its inputs, a function returning its outputs), the inputs written
    before it compiles."""
    d = tmp_path_factory.mktemp("tt_ref")
    ins, outs = d / "inputs.pkl", d / "outputs.pkl"
    env = {**os.environ, "PYTHONPATH": f"{ROOT / 'src'}{os.pathsep}{ROOT / 'tests'}",
           "JAX_PLATFORMS": "cpu", "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen([sys.executable, str(ROOT / "tests" / "tp_train_reference.py"),
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
def whole(inputs):
    """The port's one-rank steps and round-start scalars (``tt_whole``)."""
    return tt_whole(inputs)


@pytest.fixture(scope="module")
def repro_out(reference):
    return reference[1]()


def _world(key):
    @pytest.fixture(scope="module")
    def world(reference):
        mesh, n = MESHES[key]
        # the planted faults run on the smallest world only
        return spawn(tp_train, n, {"mesh": mesh, "ref": reference[0], "faults": key == "model2"})
    return world


model2, model4, data2_model2 = _world("model2"), _world("model4"), _world("data2_model2")


# the archs whose aux loss and capacity are per gradient chunk (the others'
# chunk mean is the batch's): a data axis of 2 holds them to grad_chunks 2
MOE = {case for case, (arch, _) in TT_CASES.items() if "moe" in arch}


def _chunks(key, case):
    return 2 if key == "data2_model2" and case in MOE else 1


def _held(got, want):
    """(state', global delta', loss) against ``want`` at ``TOL``."""
    (gs, gg, gl), (ws, wg, wl) = got, want
    assert len(gs) == len(ws) and len(gg) == len(wg)
    for g, w in zip(gs + gg, ws + wg):
        np.testing.assert_allclose(g, w, **TOL)
    np.testing.assert_allclose(gl, wl, **TOL)


def _leaves(tree):
    import jax

    return [np.asarray(x) for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("case", list(TT_CASES))
@pytest.mark.parametrize("key", list(MESHES))
def test_tp_train_step_matches_the_one_rank_step(request, key, case, whole):
    ranks = request.getfixturevalue(key)
    _held(ranks[0]["cases"][case]["whole"], whole[case][_chunks(key, case)])


@pytest.mark.parametrize("key", list(MESHES))
def test_replicated_leaves_and_loss_are_bitwise_across_ranks(request, key):
    ranks = request.getfixturevalue(key)
    for case in TT_CASES:
        digests = [r["cases"][case]["digests"] for r in ranks]
        assert len(digests[0]) > 1, case  # the loss and at least one replicated leaf
        assert all(d == digests[0] for d in digests), case


@pytest.mark.parametrize("key", list(MESHES))
def test_round_start_on_slices_matches_the_whole_tree(request, key, whole):
    """(beta, eta1 * coeff) from the ranks' slices (the replicated leaves
    counted once) against the whole tree's, on every rank."""
    for r in request.getfixturevalue(key):
        for case in TT_CASES:
            np.testing.assert_allclose(r["cases"][case]["round_start"],
                                       whole[case]["round_start"], rtol=1e-5, atol=0)


def test_data_split_is_bitwise_the_in_body_chunks(data2_model2):
    for r in data2_model2:
        assert all(r["cases"][case]["data_split_bitwise"] for case in TT_CASES)


@pytest.mark.parametrize("case", list(TT_CASES))
@pytest.mark.parametrize("key", list(MESHES))
def test_tp_train_step_matches_repro_s_partitioned_step(request, key, case, repro_out):
    ranks = request.getfixturevalue(key)
    ref = repro_out[case]
    out = ref["out2"] if _chunks(key, case) == 2 else ref["out"]
    _held(ranks[0]["cases"][case]["whole"], (_leaves(out[0]), _leaves(out[1]), out[2]))


@pytest.mark.parametrize("fault", list(tt_faults()))
def test_planted_faults_fail_their_check(model2, whole, fault):
    """Each planted fault, on ``pods:1x1x2``, fails the one-rank check of
    the step's outputs or of the round start's scalars; the same case's
    sound run passes both."""
    case = tt_faults()[fault][0]
    got, want = model2[0]["faults"][fault], whole[case]
    caught = False
    try:
        _held(got["whole"], want[1])
        np.testing.assert_allclose(got["round_start"], want["round_start"], rtol=1e-5, atol=0)
    except AssertionError:
        caught = True
    assert caught, fault
    sound = model2[0]["cases"][case]
    _held(sound["whole"], want[1])
    np.testing.assert_allclose(sound["round_start"], want["round_start"], rtol=1e-5, atol=0)


def _checkpoint(d):
    step = sorted(Path(d).glob("step_*"))[-1]
    with np.load(step / "arrays.npz") as z:
        return step.name, {k: z[k] for k in z.files}


def test_train_cli_on_a_mesh_writes_the_one_rank_checkpoint(tmp_path):
    """``torchrun --nproc-per-node 2 -m repro_torch.launch.train --mesh
    pods:1x1x2``: the tensor-parallel step, and a checkpoint of whole
    leaves equal to the one-rank run's within 1e-5."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    argv = ["-m", "repro_torch.launch.train", "--device", "cpu", "--rounds", "1",
            "--seq-len", "16", "--arch", "gemma3-1b", "--obs-quiet"]
    one = subprocess.run([sys.executable, *argv, "--checkpoint-dir", str(tmp_path / "one")],
                         env=env, capture_output=True, text=True, timeout=120)
    assert one.returncode == 0, one.stderr[-4000:]
    tp = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
                         "--standalone", *argv, "--mesh", "pods:1x1x2",
                         "--checkpoint-dir", str(tmp_path / "tp")],
                        env=env, capture_output=True, text=True, timeout=180)
    assert tp.returncode == 0, tp.stderr[-4000:]
    (s1, a1), (s2, a2) = _checkpoint(tmp_path / "one"), _checkpoint(tmp_path / "tp")
    assert s1 == s2 and sorted(a1) == sorted(a2)
    for k in a1:
        assert a1[k].shape == a2[k].shape, k  # whole leaves
        np.testing.assert_allclose(a2[k], a1[k], **TOL)
