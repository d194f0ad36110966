"""Multi-process gloo workers for ``tests/test_torch_multidevice.py``.

``spawn(fn, world, *args)`` starts ``world`` processes (the ``spawn``
start method), each joining a gloo group on localhost with a 60 s
collective timeout and one intra-op thread, and returns every rank's
``fn(rank, world, *args)``.  A worker that raises fails the call with its
traceback; one that has not answered after ``JOIN_S`` seconds is killed
and fails the call, so a hung collective fails its test instead of
running into the suite's clock.

The worker functions below import only ``repro_torch`` (a worker starts
from a fresh interpreter: no JAX to load).  ``setup`` makes the small
federation every test builds (the small CNN, 8 clients, 400 images).
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
import queue
import socket
import sys
import time
import traceback

import numpy as np

JOIN_S = 120.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(fn, rank, world, port, out, args):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=60))
        try:
            result = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, result))
    except BaseException:  # the parent fails the test with this traceback
        out.put((rank, False, traceback.format_exc()))


def spawn(fn, world: int, *args):
    """[fn(rank, world, *args) for each rank], run in ``world`` processes."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_entry, args=(fn, r, world, port, out, args), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, []
    deadline = time.monotonic() + JOIN_S
    try:
        while len(results) + len(errors) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{world - len(results) - len(errors)} of {world} "
                                   f"ranks did not answer within {JOIN_S:.0f} s")
            try:
                rank, ok, value = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                if errors or any(p.exitcode not in (None, 0) for p in procs):
                    # a rank died without answering: its peers would hang
                    break
                continue
            if ok:
                results[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
    finally:
        for p in procs:
            p.join(timeout=max(0.1, deadline - time.monotonic()))
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
    if errors or len(results) < world:
        raise AssertionError("\n".join(errors) or
                             f"ranks {sorted(set(range(world)) - set(results))} exited "
                             f"with {[p.exitcode for p in procs]} and no answer")
    return [results[r] for r in range(world)]


# ---------------------------------------------------------------------------
# the federation every test builds
# ---------------------------------------------------------------------------

KW = dict(n_clients=8, participation=0.5, batch=16, local_iters=2, seed=0)


def setup():
    """(data, init params, cfg) of the small federation."""
    import torch

    from repro_torch.configs.resnet_cifar import SMALL_CNN
    from repro_torch.data import FederatedData, dirichlet_partition
    from repro_torch.data import make_class_conditional_images
    from repro_torch.models import cnn

    images, labels = make_class_conditional_images(400, 10, 16, seed=0)
    data = FederatedData.from_partition(
        images, labels, dirichlet_partition(labels, 8, alpha=0.07, seed=0), seed=0)
    params = cnn.init_params(torch.Generator().manual_seed(0), SMALL_CNN, device="cpu")
    return data, params, SMALL_CNN


def method(name):
    from repro_torch.core import baselines as bl

    return bl.METHODS[name]() if name in bl.METHODS else bl.FedExP()


def federation(name, rounds=2, mode="sync", async_cfg=None, **kw):
    from repro_torch.fl import AsyncFederation, Federation, FLRunConfig, masked_accuracy
    from repro_torch.models import cnn

    data, params, cfg = setup()
    loss = lambda p, b: cnn.loss_fn(p, cfg, b)
    acc = masked_accuracy(lambda p, t: cnn.apply(p, cfg, t["images"]))
    run = FLRunConfig(rounds=rounds, **{**KW, **kw})
    if mode == "async":
        return AsyncFederation(method(name), loss, acc, params, data, run,
                               async_cfg=async_cfg, device="cpu")
    return Federation(method(name), loss, acc, params, data, run, device="cpu")


def final(fed):
    """(history, final client rows, broadcast) as numpy."""
    import torch

    from repro_torch.utils.pytree import tree_leaves

    h = fed.run()
    rows = [np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x).copy()
            for x in tree_leaves(fed.client_states)]
    return ({k: h[k] for k in ("loss", "acc", "sim_time", "mean_best_acc")},
            rows, [x.numpy().copy() for x in tree_leaves(fed.broadcast)])


def record_dispatches(fed):
    """Wrap ``fed._dispatch`` to log (sim_time, ids) of every dispatch."""
    log = []
    inner = fed._dispatch

    def dispatch(ids):
        log.append((float(fed.sim_time), [int(i) for i in ids]))
        return inner(ids)

    fed._dispatch = dispatch
    return log


# ---------------------------------------------------------------------------
# workers
# ---------------------------------------------------------------------------


def _operands(seed, c, n, dtype, shared):
    import torch

    g = torch.Generator().manual_seed(seed)
    x = torch.randn(c, n, generator=g).to(dtype)
    di = (0.01 * torch.randn(c, n, generator=g)).to(dtype)
    dg = (0.01 * torch.randn(n if shared else c * n, generator=g)).to(dtype)
    return x, di, dg if shared else dg.view(c, n)


UPDATE_CASES = [  # (seed, C, N, dtype, shared d_g): ragged tails, bf16
    (0, 3, 4096 * 7 + 123, "float32", True),
    (1, 2, 4096 * 5, "float32", False),
    (2, 4, 4096 * 3 + 5, "bfloat16", True),
    (3, 1, 4096 * 9 + 1, "float32", True),
]


def reduce_and_update(rank, world):
    """The sharded cohort reductions over the whole world and the sharded
    update over the world and over every prefix group of 2..world-1 ranks
    (m = 2, 3, ...), each against its unsharded self; returns the census."""
    import torch
    import torch.distributed as dist

    from repro_torch.kernels.dispatch import client_shard_axis
    from repro_torch.kernels.pfedsop_update import ops
    from repro_torch.launch import collectives
    from repro_torch.optim import reduce

    group = dist.group.WORLD
    checks = 0
    for seed, rows in [(0, 2 * world), (1, world), (2, 3 * world)]:
        g = torch.Generator().manual_seed(seed)
        tree = {"a": torch.randn(rows, 37, generator=g),
                "b": torch.randn(rows, 3, 5, generator=g).to(torch.bfloat16)}
        want_mean, want_sum = reduce.cohort_mean(tree), reduce.cohort_sum(tree["a"])
        k = rows // world
        local = {n: v[rank * k:(rank + 1) * k] for n, v in tree.items()}
        with client_shard_axis(group, world):
            got_mean, got_sum = reduce.cohort_mean(local), reduce.cohort_sum(local["a"])
            assert reduce.cohort_size(k) == rows
        for n in tree:
            assert torch.equal(got_mean[n], want_mean[n]), (world, seed, n)
        assert torch.equal(got_sum, want_sum), (world, seed)
        checks += 1
    # groups of m = 2 .. world ranks (every rank creates every group)
    groups = {m: dist.new_group(list(range(m))) for m in range(2, world)}
    groups[world] = group
    for seed, c, n, dtype, shared in UPDATE_CASES:
        x, di, dg = _operands(seed, c, n, getattr(torch, dtype), shared)
        want_x, want_b = ops.pfedsop_update_batched(x, di, dg, 0.05, 1.0, 1.0)
        for m, grp in groups.items():
            if rank >= m:
                continue
            got_x, got_b = ops.pfedsop_update_batched_sharded(
                x, di, dg, grp, m, comm=collectives, eta1=0.05, rho=1.0, lam=1.0)
            assert torch.equal(got_x, want_x) and torch.equal(got_b, want_b), (m, seed)
            checks += 1
    assert ops.LAUNCHES == {"reduce3": 0, "update": 0}  # plain versions on the CPU
    return {"checks": checks, "census": collectives.census()}


def sync_runs(rank, world, runs):
    """Each ``(label, name, kwargs)`` of ``runs`` as a sync federation (2
    rounds unless ``kwargs`` say otherwise); rank 0 returns (history, final
    rows, broadcast, census), every rank the sums of its final rows (all
    ranks must agree) and whether its engine took the data split."""
    from repro_torch.launch import collectives

    out = {}
    for label, name, kw in runs:
        collectives.reset_census()
        fed = federation(name, **kw)
        h, rows, bc = final(fed)
        digest = [float(np.asarray(r, np.float64).sum()) for r in rows + bc]
        out[label] = ((h, rows, bc, collectives.census()) if rank == 0 else None, digest,
                      getattr(fed.engine, "data_split", None))
    return out


def async_pods(rank, world, cfg):
    """The heterogeneous async run on ``pods:Px1x1``: its dispatches and
    history (rank 0) and every rank's digest of the final rows."""
    from repro_torch.fl import AsyncConfig, AvailabilityConfig

    acfg = AsyncConfig(buffer_size=cfg["buffer"], availability=AvailabilityConfig(**cfg["avail"]))
    fed = federation("pfedsop", rounds=cfg["rounds"], mode="async", async_cfg=acfg,
                     backend="mesh", mesh=cfg["mesh"])
    log = record_dispatches(fed)
    h = fed.run()
    digest = float(np.asarray(fed.client_states.params, np.float64).sum())
    keep = {k: h[k] for k in ("loss", "acc", "sim_time", "staleness")}
    return (log, keep, fed.n_pods, h["engine"]) if rank == 0 else None, digest


def layout(rank, world):
    """``MeshBackend.input_shardings`` on a model-sharded leaf over
    ``pods:1x1x<world>``: the store's at-rest cut, then the gather over the
    model group, gives the leaf back bitwise."""
    import torch

    from repro_torch.fl.engine import make_engine

    eng = make_engine("mesh", 4, mesh=f"pods:1x1x{world}")
    g = torch.Generator().manual_seed(0)
    tree = {"embed": torch.randn(4, 8 * world, 3, generator=g),
            "x": torch.randn(4, 5, generator=g)}
    sh = eng.input_shardings(tree)
    # the store's cut: this rank's rows, then its model slice
    rest = {k: (v[sh[k].rows] if sh[k].model is None else
                v[sh[k].rows].narrow(sh[k].model[0], sh[k].model[1].start, 8))
            for k, v in tree.items()}
    assert rest["embed"].shape == (4, 8, 3) and rest["x"].shape == (4, 5)
    assert sh["embed"].model == (1, slice(8 * rank, 8 * rank + 8)) and sh["x"].model is None
    back = eng._gather_model(rest, sh)
    return all(torch.equal(back[k], tree[k]) for k in tree)


def lm_inputs(clients, iters, batch, seq_len, seed=3):
    """gemma3-1b-smoke's train-step inputs from a seed: the port's init,
    numpy noise on each client's params and delta and on the global delta,
    numpy tokens (clients, iters, batch, seq_len)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.utils.pytree import tree_map

    cfg = get_config("gemma3-1b", reduced=True)
    params = tf.init_params(torch.Generator().manual_seed(seed), cfg, device="cpu")
    rng = np.random.RandomState(seed)

    def noise(x):
        return torch.from_numpy((0.01 * rng.standard_normal(tuple(x.shape))).astype(np.float32))

    def stack(make):
        return tree_map(lambda x: torch.stack([make(x) for _ in range(clients)]), params)

    state = {"params": stack(lambda x: x + noise(x)), "delta": stack(noise)}
    global_delta = tree_map(noise, params)
    toks = rng.randint(0, cfg.vocab_size, (clients, iters, batch, seq_len)).astype(np.int32)
    batches = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(np.roll(toks, -1, -1))}
    return cfg, state, global_delta, batches


def _same_trees(a, b) -> bool:
    import torch

    from repro_torch.utils.pytree import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def lm_mesh_steps(rank, world):
    """``launch/steps.py::make_train_step`` on mesh engines at world 2
    (2 clients, 2 local iterations, batch 2, gemma3-1b-smoke), each against
    the engine-less step on the same inputs, bit for bit:

      data     ``pods:1x2x1`` at ``grad_chunks`` 2: the data split (each rank
               one chunk of each batch) against the in-body chunks;
      pods     ``pods:2x1x1``: one client a rank, Eq. 13 over the ranks;
      model    ``pods:1x1x2``: the round start on tile ranges;
      in_body  ``pods:1x2x1`` with a batch of 3 (the data size does not
               divide it), one chunk: the in-body path.

    Returns per case (bitwise, the census, the engine's data split)."""
    from repro_torch.configs.base import InputShape
    from repro_torch.core.pfedsop import PFedSOPConfig
    from repro_torch.fl.engine import MeshBackend, client_tree
    from repro_torch.kernels.dispatch import grad_chunk_count
    from repro_torch.launch import collectives, steps
    from repro_torch.launch.mesh import parse_mesh

    pcfg = PFedSOPConfig(eta1=0.1, eta2=0.1)
    cfg, state, gd, batches = lm_inputs(2, 2, 2, 32)
    b3 = lm_inputs(2, 2, 3, 32, seed=4)[3]

    def step(mesh=None, chunks=1, b=batches, data_chunks=0):
        engine = mesh and MeshBackend(2, parse_mesh(mesh), data_chunks=data_chunks)
        shape = InputShape("small", 32, 2 * b["tokens"].shape[2], "train")
        collectives.reset_census()
        with grad_chunk_count(chunks):
            out = steps.make_train_step(cfg, shape, pcfg, engine=engine)(state, gd, b)
        return out, collectives.census(), getattr(engine, "data_split", None)

    ref1, ref2, ref3 = step()[0], step(chunks=2)[0], step(b=b3)[0]
    out = {"chunks_differ": not _same_trees(ref1, ref2)}
    got, census, split = step("pods:1x2x1", chunks=2, data_chunks=2)
    out["data"] = (_same_trees(got, ref2), census, split)
    (s, g, loss), census, split = step("pods:2x1x1")
    rows = client_tree(ref1[0], slice(rank, rank + 1))
    out["pods"] = (_same_trees((s, g, loss), (rows, ref1[1], ref1[2])), census, split)
    got, census, split = step("pods:1x1x2")
    out["model"] = (_same_trees(got, ref1), census, split)
    got, census, split = step("pods:1x2x1", b=b3, data_chunks=2)
    out["in_body"] = (_same_trees(got, ref3), census, split)
    return out


# tests/test_torch_tp_serve.py: its cases, shared with the JAX reference
# (tests/tp_serve_reference.py), which imports them from here
TP_B, TP_S, TP_T = 4, 12, 8  # batch, prompt, decode steps
TP_CAPACITY = TP_S + TP_T
TP_CASES = {  # name -> (arch, variant): see tp_config
    "gemma3-1b": ("gemma3-1b", "base"),
    "gemma3-1b/wrap": ("gemma3-1b", "wrap"),
    "gemma3-1b/head_dim": ("gemma3-1b", "head_dim"),
    "gemma2-9b/wrap": ("gemma2-9b", "wrap"),
    "granite-3-2b": ("granite-3-2b", "base"),
}


def tp_config(get, arch: str, variant: str):
    """The reduced config of ``arch`` (``get`` is either package's
    ``get_config``), with the variant applied alike in both packages:
    ``wrap`` (window 8, full) x 2 + a window-8 tail layer, so the ring
    buffers wrap and split over the model ranks; ``head_dim`` one query
    and one KV head, so every attention projection splits ``head_dim``."""
    cfg = get(arch, reduced=True)
    if variant == "wrap":
        local = cfg.pattern[0].replace(window=8)
        glob = cfg.pattern[-1].replace(window=None)
        cfg = cfg.replace(pattern=(local, glob), n_rep=2, tail=(local,), n_layers=5)
    elif variant == "head_dim":
        cfg = cfg.replace(n_heads=1, n_kv_heads=1)
    return cfg


def _argmax_ties(tp):
    """``parallel.vocab_argmax`` on this rank's vocab slice of logits with
    ties inside a slice, across slices and over the whole row, against
    ``argmax`` of the whole logits."""
    import torch

    from repro_torch.models import parallel

    v = 8 * tp.size
    whole = torch.randint(0, 3, (6, 1, v), generator=torch.Generator().manual_seed(0)).float()
    whole[0, 0, :] = 0.0
    whole[0, 0, [1, v - 1]] = 5.0  # across slices
    whole[1, 0, :] = 1.0  # the whole row
    whole[2, 0, v // 2:] = 7.0  # the last slice only
    whole[3, 0, [v // 2 - 1, v // 2]] = 9.0  # either side of a boundary
    local = whole[..., tp.slice_of(v)].contiguous()
    got = parallel.vocab_argmax(local, tp, v)
    return got.tolist(), whole.argmax(-1).tolist()


def _combine_unscaled(m, l, o, tp):
    """A planted fault: ``parallel.combine_attention`` with each rank's part
    weighted 1 where it must be weighted ``exp(m_r - M)``."""
    import torch

    from repro_torch.models import parallel

    parts = parallel.gather(torch.cat([l, o], dim=-1).unsqueeze(0), tp, 0)
    return parts[..., 1:].sum(0) / parts[..., :1].sum(0)


def tp_faults():
    """The planted faults of tensor-parallel serving: name -> (module,
    attribute, the faulty replacement)."""
    import dataclasses

    import torch

    from repro_torch.models import attention, parallel

    argmax = parallel.vocab_argmax
    return {
        "row_all_reduce_dropped": (parallel, "row",
                                   lambda eq, x, w, tp: torch.einsum(eq, x, w)),
        "owner_write_skipped": (attention, "_write_owned", lambda buf, slot, value, lo: None),
        "combine_unscaled": (parallel, "combine_attention", _combine_unscaled),
        # each rank taking itself for rank 0: no slice offset
        "argmax_offset_dropped": (parallel, "vocab_argmax", lambda logits, tp, vocab: argmax(
            logits, dataclasses.replace(tp, rank=0), vocab)),
    }


TP_FAULT_CASE = "gemma3-1b/wrap"  # the planted faults' case: both ranks own written slots


def tp_serve(rank, world, plan):
    """The dense archs' tensor-parallel serving on ``plan["mesh"]``, per
    case of ``TP_CASES``, from the params and prompt of the JAX reference
    (``plan["ref"]``, pickled by ``tests/tp_serve_reference.py``): the
    prefill step's logits (whole), ``prefill_with_caches``'s logits and
    each decode step's (this data rank's rows, gathered over the vocab),
    teacher-forced on the reference's inputs, and the serve step's tokens
    (whole); with this rank's rows and the census of the two steps.  With
    ``plan["faults"]``, the same for ``TP_FAULT_CASE`` under each planted
    fault of ``tp_faults``."""
    import pickle

    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import collectives, steps
    from repro_torch.launch.mesh import parse_mesh
    from repro_torch.launch.sharding import rank_plan
    from repro_torch.models import parallel
    from repro_torch.models import transformer as tf
    from repro_torch.weights import cut, params_from_jax

    tp = steps.tensor_parallel(parse_mesh(plan["mesh"]))
    with open(plan["ref"], "rb") as f:
        ref = pickle.load(f)
    shape = InputShape("tp_serve", TP_CAPACITY, TP_B, "prefill")
    out = {"argmax": _argmax_ties(tp), "cases": {}, "faults": {}}

    def rows(x):
        return cut({"tokens": x}, rank_plan({"tokens": x}, "batch", tp.data_size,
                                            drank=tp.data_rank))["tokens"]

    def vocab(logits, cfg):
        return parallel.gather(logits, tp, -1) if logits.shape[-1] != cfg.vocab_size else logits

    def serve_case(name):
        arch, variant = TP_CASES[name]
        cfg, r = tp_config(get_config, arch, variant), ref[name]
        whole = params_from_jax(r["params"], device="cpu")
        params = cut(whole, rank_plan(whole, "params", tp.data_size, tp.size, tp.data_rank,
                                      tp.rank))
        batch = {"tokens": rows(torch.from_numpy(r["prompt"]))}
        collectives.reset_census()
        step_logits = steps.make_prefill_step(cfg, shape, tp)(params, batch)
        census = {"prefill_step": collectives.census()}
        logits, caches = tf.prefill_with_caches(params, cfg, batch, TP_CAPACITY, tp)
        serve = steps.make_serve_step(cfg, shape, tp)
        decoded, served = [], []
        for t in range(TP_T):
            tok = {"tokens": rows(torch.from_numpy(r["inputs"][t]))}
            pos = torch.tensor(TP_S + t, dtype=torch.int32)
            collectives.reset_census()
            tokens, caches = serve(params, tok, pos, caches)
            census.setdefault("serve_step", collectives.census())
            # the same slot rewritten with the same values
            step, caches = tf.decode_step(params, cfg, tok, pos, caches, tp)
            decoded.append(vocab(step, cfg).numpy())
            served.append(tokens.numpy())
        n = batch["tokens"].shape[0]
        return {"rows": (tp.data_rank * n, (tp.data_rank + 1) * n) if n < TP_B else (0, TP_B),
                "prefill_step": step_logits.numpy(), "prefill": vocab(logits, cfg).numpy(),
                "decode": decoded, "serve": served, "census": census}

    for name in TP_CASES:
        out["cases"][name] = serve_case(name)
    for fault, (module, attr, faulty) in (tp_faults().items() if plan.get("faults") else ()):
        sound = getattr(module, attr)
        setattr(module, attr, faulty)
        try:
            out["faults"][fault] = serve_case(TP_FAULT_CASE)
        finally:
            setattr(module, attr, sound)
    return out


def everything(rank, world, plan):
    """One spawn's worth of checks: the reductions and the update, the
    layout (2 ranks), the LM train step on mesh engines (2 ranks), the sync
    runs and the async run of ``plan``."""
    out = {"reduce_update": reduce_and_update(rank, world)}
    if plan.get("layout"):
        out["layout"] = layout(rank, world)
    if plan.get("lm"):
        out["lm"] = lm_mesh_steps(rank, world)
    out["sync"] = sync_runs(rank, world, plan.get("sync", []))
    if plan.get("async"):
        out["async"] = async_pods(rank, world, plan["async"])
    return out


if __name__ == "__main__":
    sys.exit("import this module; see tests/test_torch_multidevice.py")
