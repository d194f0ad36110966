"""The LM train step on a mesh engine, ``launch/train.py`` and the dry run's
16x16 and 2x16x16 meshes, against ``repro`` and against the port's own
one-device results.  (The multi-rank runs are gloo processes in
``tests/test_torch_multidevice.py``.)

- The gradient chunks of the LM tree path (``optim/sgd.py::
  tree_sgd_loop``): one step at ``grad_chunks`` 2 is bitwise the halving
  tree of the two chunk gradients; ``make_train_step`` and the federated LM
  loop under ``grad_chunk_count(2)`` equal ``repro``'s under its
  ``grad_chunk_count(2)`` within ``tests/test_torch_dryrun.py``'s and
  ``tests/test_torch_lm.py``'s tolerances, and differ from their own
  one-chunk results (the chunks are read).
- ``make_train_step(engine=MeshBackend(2, pods:1x1x1))`` in a one-rank gloo
  group: bitwise the engine-less step, and within tolerance of ``repro``'s
  engine-less step.
- ``launch/train.py`` on the CPU: replicated and sharded give the same
  losses and states; ``--checkpoint-dir`` writes what
  ``utils/checkpoint.py`` reads back; ``--production-mesh`` at world 1 is
  refused with the mesh grammar.
- The dry run: rank 0's census on ``pod:2x2`` and ``pods:2x2x2`` at
  gemma3-1b-smoke, and on the 2x16x16 mesh at full width (train_4k), equal
  to the bytes and counts worked out from ``repro``'s sharding rules
  (``repro.launch.sharding.param_pspecs``) and the step's structure; the
  argument bytes equal the state at rest those rules give; the CLI's
  ``--mesh both`` writes the two records.  A dense arch's serving record
  on a mesh is rank 0's tensor-parallel program: its argument bytes the
  byte sum of its slices by those rules, with a nonempty census; a
  non-dense arch's says ``"whole_client"`` and counts no collective.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from test_torch_dryrun import _train_inputs
from test_torch_lm import _jax_loop

from repro.configs import get_config as j_get_config
from repro.core import pfedsop as j_pf
from repro.kernels.dispatch import grad_chunk_count as j_grad_chunk_count
from repro.launch import sharding as j_sharding
from repro.launch import steps as j_steps
from repro.models import transformer as j_tf
from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.configs.base import InputShape
from repro_torch.core import pfedsop as t_pf
from repro_torch.fl.engine import MeshBackend
from repro_torch.kernels.dispatch import grad_chunk_count
from repro_torch.kernels.pfedsop_update import ops as update_ops
from repro_torch.launch import collectives, dryrun
from repro_torch.launch import steps as t_steps
from repro_torch.launch import train
from repro_torch.launch import train_lm_pfedsop as driver
from repro_torch.launch.mesh import MeshSpec, parse_mesh
from repro_torch.models import transformer as t_tf
from repro_torch.optim import sgd
from repro_torch.optim.reduce import chunk_mean
from repro_torch.utils.checkpoint import load_checkpoint
from repro_torch.utils.pytree import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.weights import params_from_jax

SHAPE = InputShape("small", seq_len=32, global_batch=4, kind="train")  # T = 2 at batch 2
J_PCFG = j_pf.PFedSOPConfig(eta1=0.1, eta2=0.1)
T_PCFG = t_pf.PFedSOPConfig(eta1=0.1, eta2=0.1)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def one_rank():
    """A one-rank gloo group in this process, destroyed after the test."""
    collectives.init_world("cpu")
    yield
    dist.destroy_process_group()


def _same(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _close(got, want, rtol=5e-4, atol=1e-5):
    leaves = jax.tree.leaves(want)
    assert len(tree_leaves(got)) == len(leaves)
    for a, b in zip(tree_leaves(got), leaves):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=rtol, atol=atol)


# -- the gradient chunks of the tree path ----------------------------------------


def test_tree_sgd_loop_takes_the_halving_tree_of_the_chunk_gradients():
    cfg = get_config("gemma3-1b", reduced=True)
    params = t_tf.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    rng = np.random.RandomState(0)
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, (1, 2, 16)).astype(np.int32))
    batches = {"tokens": toks, "labels": toks.roll(-1, -1)}
    loss_fn = lambda p, b: t_tf.lm_loss(p, cfg, b)  # noqa: E731
    with grad_chunk_count(2):
        got, loss = sgd.tree_sgd_loop(loss_fn, params, batches, 0.1)
    leaves, treedef = tree_flatten(params)
    losses, grads = [], []
    for i in range(2):
        req = [x.detach().requires_grad_() for x in leaves]
        chunk = {k: v[0, i:i + 1] for k, v in batches.items()}
        value = loss_fn(tree_unflatten(treedef, req), chunk)
        losses.append(value.detach().float())
        grads.append(torch.autograd.grad(value, req))
    g = [chunk_mean(torch.stack([gi[j].float() for gi in grads])).to(x.dtype)
         for j, x in enumerate(leaves)]
    want = tree_unflatten(treedef, [(x.float() - 0.1 * gj.float()).to(x.dtype)
                                    for x, gj in zip(leaves, g)])
    assert _same(got, want)
    assert torch.equal(loss, chunk_mean(torch.stack(losses)))
    one, _ = sgd.tree_sgd_loop(loss_fn, params, batches, 0.1)
    assert not _same(one, got)


@pytest.mark.parametrize("arch", ["gemma3-1b", "granite-moe-1b-a400m"])
def test_make_train_step_at_two_chunks_matches_repro(arch):
    """Two clients, two local iterations of batch 2, the personalization on:
    ``repro``'s step traced under its ``grad_chunk_count(2)``."""
    jcfg = j_get_config(arch, reduced=True)
    tcfg = get_config(arch, reduced=True)
    j_args, t_args = _train_inputs(jcfg, clients=2, iters=2, batch=2, seq_len=32, seed=3)
    with j_grad_chunk_count(2):
        j_state, j_global, j_loss = jax.jit(j_steps.make_train_step(jcfg, SHAPE, J_PCFG))(
            *j_args)
    step = t_steps.make_train_step(tcfg, SHAPE, T_PCFG)
    with grad_chunk_count(2):
        t_state, t_global, t_loss = step(*t_args)
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-6)
    _close(t_state, j_state)
    _close(t_global, j_global)
    assert not _same(step(*t_args)[0], t_state)  # one chunk is another gradient


def test_federated_lm_loop_at_two_chunks_matches_repro():
    """``train_lm_pfedsop.train`` (``tree_client_round``) under
    ``grad_chunk_count(2)``: 2 clients, 3 rounds, against the example's loop
    in ``repro`` under its own, at ``tests/test_torch_lm.py``'s tolerances."""
    kw = dict(clients=2, rounds=3, local_iters=2, batch=2, seq_len=32)
    jc = j_get_config("gemma3-1b", reduced=True).replace(kernel_impl="reference")
    jp = j_tf.init_params(jax.random.PRNGKey(0), jc)
    with j_grad_chunk_count(2):
        j_hist, j_states = _jax_loop(
            jc, jp, j_pf.PFedSOPConfig(eta1=0.1, eta2=0.1, update_impl="reference"), **kw)
    tc = get_config("gemma3-1b", reduced=True)
    tp = lambda: params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")  # noqa: E731
    with grad_chunk_count(2):
        t_hist, t_states = driver.train(tc, tp(), T_PCFG, **kw)
    np.testing.assert_allclose(t_hist["loss"], j_hist["loss"], rtol=1e-4)
    np.testing.assert_allclose(t_hist["beta"], j_hist["beta"], rtol=1e-4)
    for j_state, t_state in zip(j_states, t_states):
        for a, b in zip(jax.tree.leaves(j_state.params), tree_leaves(t_state.params)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-3, atol=1e-5)
    _, one = driver.train(tc, tp(), T_PCFG, **kw)
    assert not _same(one[0].params, t_states[0].params)


# -- the step on a mesh engine ------------------------------------------------------


def test_engine_step_is_the_engine_less_step_and_matches_repro(one_rank):
    jcfg = j_get_config("gemma3-1b", reduced=True)
    tcfg = get_config("gemma3-1b", reduced=True)
    j_args, t_args = _train_inputs(jcfg, clients=2, iters=2, batch=2, seq_len=32, seed=5)
    engine = MeshBackend(2, parse_mesh("pods:1x1x1"))
    got = t_steps.make_train_step(tcfg, SHAPE, T_PCFG, engine=engine)(*t_args)
    assert _same(got, t_steps.make_train_step(tcfg, SHAPE, T_PCFG)(*t_args))
    assert engine.data_split is False and not engine.client_sharded
    j_state, j_global, j_loss = jax.jit(j_steps.make_train_step(jcfg, SHAPE, J_PCFG))(*j_args)
    np.testing.assert_allclose(float(got[2]), float(j_loss), rtol=1e-6)
    _close(got[0], j_state)
    _close(got[1], j_global)


# -- launch/train.py --------------------------------------------------------------


def test_train_replicated_and_sharded_give_the_same_rounds(one_rank, tmp_path):
    cfg = get_config("gemma3-1b", reduced=True).replace(kernel_impl="auto")
    kw = dict(rounds=2, local_iters=2, micro_batch=2, seq_len=16, seed=1, device="cpu")
    h_rep, (s_rep, g_rep) = train.run(cfg, output_sharding="replicated", **kw)
    h_sh, (s_sh, g_sh) = train.run(cfg, output_sharding="sharded",
                                   checkpoint_dir=str(tmp_path / "ck"), **kw)
    assert h_rep["loss"] == h_sh["loss"] and all(np.isfinite(h_rep["loss"]))
    assert _same(s_rep, s_sh) and _same(g_rep, g_sh)
    back, _ = load_checkpoint(tmp_path / "ck", s_sh)
    assert _same(back, s_sh)
    first, _ = load_checkpoint(tmp_path / "ck", s_sh, step=0)
    assert not _same(first, s_sh)


def test_train_cli_runs_on_the_cpu(tmp_path, capsys):
    train.main(["--device", "cpu", "--rounds", "2", "--output-sharding", "sharded",
                "--seq-len", "16", "--checkpoint-dir", str(tmp_path / "ck"),
                "--trace-dir", str(tmp_path / "tr")])
    out = capsys.readouterr().out
    assert "round 1 loss=" in out and out.strip().endswith("OK")
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["step_00000000",
                                                                   "step_00000001"]
    assert (tmp_path / "tr" / "metrics.jsonl").exists()
    assert not dist.is_initialized()


def test_train_refuses_the_production_mesh_at_one_rank():
    with pytest.raises(RuntimeError, match="needs 256 ranks.*mesh spec grammar"):
        train.main(["--device", "cpu", "--production-mesh", "--rounds", "1"])
    assert not dist.is_initialized()
    with pytest.raises(SystemExit):
        train.parse_args(["--kernel-impl", "kernel_interpret"])


# -- the dry run on meshes -----------------------------------------------------------


def _leaf_bytes(x):
    return int(np.prod(x.shape)) * np.dtype(x.dtype).itemsize


def expected(arch, jshape, spec: MeshSpec, micro_batch, reduced=False):
    """Rank 0's census and argument bytes of the train step, from ``repro``'s
    sharding rules and the step's structure: the model-sharded leaves of the
    one local client's params and delta gathered over the model group; the
    round start's partials all-reduced and its output (f32) gathered; each
    local step's f32 loss and gradient leaves gathered over the data group;
    multi-pod, Eq. 13's f32 partial of every delta leaf and of the loss
    gathered over the pods."""
    cfg = j_get_config(arch, reduced=reduced)
    p, d, m = spec.client_size, spec.data_size, spec.model_size
    specs = j_steps.input_specs(cfg, jshape, n_clients=p, micro_batch=micro_batch)
    params = j_steps.abstract_params(cfg)
    leaves = jax.tree.leaves(params)
    numel = [int(np.prod(x.shape)) for x in leaves]
    n = sum(numel)
    t_iters = jax.tree.leaves(specs["batches"])[0].shape[1]
    split = jax.tree.leaves(specs["state"]["params"])
    pspecs = jax.tree.leaves(j_sharding.param_pspecs(specs["state"]["params"], m, client=True),
                             is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    sharded = [m > 1 and "model" in tuple(s) for s in pspecs]
    gathers = bytes_ = 0
    # the engine's gather of the model-sharded leaves (params and delta)
    for x, sh in zip(split, sharded):
        if sh:
            gathers += 2
            bytes_ += 2 * _leaf_bytes(x) // p
    reduces = reduce_bytes = 0
    if m > 1:  # the round start on tile ranges
        tl = -(-math.ceil(n / update_ops.TILE) // m)
        reduces, reduce_bytes = 1, tl * m * 3 * 4
        gathers += 1
        bytes_ += tl * update_ops.TILE * m * 4
    if d > 1:  # the data split: every step's loss and gradient leaves
        gathers += t_iters * (1 + len(leaves))
        bytes_ += t_iters * d * 4 * (1 + n)
    if p > 1:  # Eq. 13 over the pods
        gathers += len(leaves) + 1
        bytes_ += p * 4 * (n + 1)
    census = {"all-gather": {"bytes": bytes_, "count": gathers}}
    if reduces:
        census["all-reduce"] = {"bytes": reduce_bytes, "count": reduces}
    # at rest: one client's rows, model slices; the global delta and batches whole
    at_rest = sum((_leaf_bytes(x) // p) // (m if sh else 1) for x, sh in zip(split, sharded))
    argument = (2 * at_rest + sum(_leaf_bytes(x) for x in jax.tree.leaves(specs["global_delta"]))
                + sum(_leaf_bytes(x) for x in jax.tree.leaves(specs["batches"])))
    return census, argument


@pytest.mark.parametrize("spec", [MeshSpec.single_pod(2, 2), MeshSpec.multi_pod(2, 2, 2)],
                         ids=["pod:2x2", "pods:2x2x2"])
def test_mesh_census_at_reduced_width(spec):
    cfg = get_config("gemma3-1b", reduced=True)
    rec = dryrun.run_one("gemma3-1b", SHAPE, save=False, verbose=False, micro_batch=2,
                         mesh=spec, cfg=cfg)
    census, argument = expected("gemma3-1b", SHAPE, spec, 2, reduced=True)
    assert rec["collectives"] == census
    assert rec["memory_analysis"]["argument_size_in_bytes"] == argument
    assert rec["n_devices"] == spec.n_devices and rec["mesh"] == "x".join(map(str, spec.shape))
    assert rec["data_split"] is True
    assert rec["roofline"]["collective_bytes_per_device"] == census["all-gather"]["bytes"] + \
        census.get("all-reduce", {}).get("bytes", 0)
    assert not dist.is_initialized()


def test_full_width_train_4k_on_the_multi_pod_mesh():
    """gemma3-1b at full width on 2x16x16: rank 0 trains its pod's client on
    2 of each micro batch's 32 sequences and gathers the other 15 chunks."""
    rec = dryrun.run_one("gemma3-1b", "train_4k", save=False, verbose=False, mesh="multi")
    census, argument = expected("gemma3-1b", INPUT_SHAPES["train_4k"],
                                MeshSpec.multi_pod(2, 16, 16), 32)
    assert (rec["mesh"], rec["n_devices"], rec["data_split"]) == ("2x16x16", 512, True)
    assert rec["collectives"] == census
    assert rec["memory_analysis"]["argument_size_in_bytes"] == argument
    # 8 local steps of one 2-sequence chunk: the one-device step's launches
    assert rec["launches"] == {"reduce3": 1, "update": 1, "rmsnorm": 8 * 209,
                               "flash_fwd": 8 * 52, "flash_bwd_dq": 8 * 26,
                               "flash_bwd_dkv": 8 * 26, "flash_bwd_dkv_sum": 8 * 26}
    assert rec["roofline"]["total_flops"] == rec["cost_analysis"]["flops"] * 512


def serve_argument(arch, jshape, spec: MeshSpec, reduced=False):
    """Rank 0's argument bytes of a serving step: the byte sum of its
    slices of the params, the batch and the caches by ``repro``'s
    sharding rules (each leaf over the sizes of the axes its spec names),
    and the position."""
    cfg = j_get_config(arch, reduced=reduced)
    p, d, m = spec.client_size, spec.data_size, spec.model_size
    caxis = spec.client_axis
    specs = j_steps.input_specs(cfg, jshape, n_clients=p)
    sizes = {caxis: p, "data": d, "model": m}
    trees = [(specs["params"], j_sharding.param_pspecs(specs["params"], m, client=True,
                                                      client_axis=caxis)),
             (specs["batch"], j_sharding.batch_pspecs(specs["batch"], d, client=True,
                                                     client_axis=caxis))]
    if jshape.kind == "decode":
        trees.append((specs["caches"], j_sharding.cache_pspecs(specs["caches"], d, m, client=True,
                                                              client_axis=caxis)))
    total = 4 if jshape.kind == "decode" else 0  # the position, int32
    for tree, pspecs in trees:
        for x, sp in zip(jax.tree.leaves(tree), jax.tree.leaves(
                pspecs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))):
            total += _leaf_bytes(x) // math.prod(sizes[ax] for ax in sp if ax is not None)
    return total


def test_cli_mesh_both_writes_the_two_records(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "ART_DIR", tmp_path)
    dryrun.main(["--arch", "gemma3-1b", "--shape", "decode_32k", "--mesh", "both"])
    got = sorted(p.name for p in tmp_path.iterdir())
    assert got == ["gemma3-1b__decode_32k__16x16.json", "gemma3-1b__decode_32k__2x16x16.json"]
    one = dryrun.run_one("gemma3-1b", "decode_32k", save=False, verbose=False)
    multi = dryrun.run_one("gemma3-1b", "decode_32k", save=False, verbose=False, mesh="multi")
    # serving a dense arch on a mesh: rank 0's tensor-parallel program, its
    # slices of the params and caches, with the collectives that needs
    assert multi["serve_layout"] == "tensor_parallel" and multi["n_devices"] == 512
    assert multi["collectives"]["all-gather"]["count"] > 0
    assert multi["collectives"]["all-reduce"]["count"] > 0
    assert multi["launches"] == one["launches"]  # K4 on whole rows on every rank
    assert multi["memory_analysis"]["argument_size_in_bytes"] == serve_argument(
        "gemma3-1b", INPUT_SHAPES["decode_32k"], MeshSpec.multi_pod(2, 16, 16))
    assert multi["peak_bytes"] < one["peak_bytes"] / 16


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("spec", [MeshSpec.single_pod(2, 2), MeshSpec.multi_pod(2, 2, 2)],
                         ids=["pod2x2", "pods2x2x2"])
def test_serve_records_at_reduced_width(spec, kind):
    """A dense arch's serving record is rank 0's tensor-parallel program
    (argument bytes the byte sum of its slices, a nonempty census); a
    non-dense arch's is its pod's client served whole, with no collective."""
    shape = InputShape("small_" + kind, 64, 4, kind)
    rec = dryrun.run_one("gemma3-1b", shape, save=False, verbose=False, mesh=spec,
                         cfg=get_config("gemma3-1b", reduced=True))
    assert rec["serve_layout"] == "tensor_parallel"
    assert rec["memory_analysis"]["argument_size_in_bytes"] == serve_argument(
        "gemma3-1b", shape, spec, reduced=True)
    assert rec["collectives"]["all-gather"]["count"] > 0
    assert rec["collectives"]["all-reduce"]["count"] > 0
    moe = dryrun.run_one("granite-moe-1b-a400m", shape, save=False, verbose=False, mesh=spec,
                         cfg=get_config("granite-moe-1b-a400m", reduced=True))
    one = dryrun.run_one("granite-moe-1b-a400m", shape, save=False, verbose=False,
                         cfg=get_config("granite-moe-1b-a400m", reduced=True))
    assert moe["serve_layout"] == "whole_client" and moe["collectives"] == {}
    assert moe["memory_analysis"] == one["memory_analysis"]
    assert not dist.is_initialized()
