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


# tests/test_torch_tp_serve_archs.py: the MoE, SSM, hybrid and frontend
# archs, each reduced so that every rule splits at m = 2 and 4, but one
TPA_CASES = {
    "granite-moe": ("granite-moe-1b-a400m", "base"),
    "granite-moe/dispatch": ("granite-moe-1b-a400m", "dispatch"),
    "granite-moe/dispatch_grouped": ("granite-moe-1b-a400m", "dispatch_grouped"),
    "olmoe-1b-7b": ("olmoe-1b-7b", "experts8"),
    "mamba2-2.7b": ("mamba2-2.7b", "base"),
    "mamba2-2.7b/whole_leaves": ("mamba2-2.7b", "whole_leaves"),
    "zamba2-2.7b": ("zamba2-2.7b", "two_reps"),
    "internvl2-2b": ("internvl2-2b", "odd_vocab"),
    "musicgen-large": ("musicgen-large", "base"),
}


def tp_config(get, arch: str, variant: str):
    """The reduced config of ``arch`` (``get`` is either package's
    ``get_config``), with the variant applied alike in both packages:

      wrap          (window 8, full) x 2 + a window-8 tail layer, so the
                    ring buffers wrap and split over the model ranks;
      head_dim      one query and one KV head, so every attention
                    projection splits ``head_dim``;
      dispatch, dispatch_grouped  that MoE impl at capacity factor 0.5,
                    so slots are dropped;
      experts8      8 experts, top 4;
      whole_leaves  d_model 96: 3 SSM heads, so ``in_proj`` (Z = 419) and
                    the ``state`` stay whole at m = 2 and 4 while
                    ``conv_w``/``conv_b`` (C = 224) and ``out_proj`` (192
                    rows, cut inside a head) split;
      two_reps      zamba2's (ssm, shared_attn) pattern twice: two
                    invocations of the shared block, a cache each;
      odd_vocab     509 tokens (odd, as internvl2-2b's 92,553: ``embed``
                    whole at every m) and 2 KV heads under 4 (G = 2);
      chunk4        SSD chunks of 4 positions, so that a rank of a
                    sequence-parallel prefill holds several."""
    cfg = get(arch, reduced=True)
    if variant == "wrap":
        local = cfg.pattern[0].replace(window=8)
        glob = cfg.pattern[-1].replace(window=None)
        cfg = cfg.replace(pattern=(local, glob), n_rep=2, tail=(local,), n_layers=5)
    elif variant == "head_dim":
        cfg = cfg.replace(n_heads=1, n_kv_heads=1)
    elif variant in ("dispatch", "dispatch_grouped"):
        cfg = cfg.replace(moe_impl=variant, capacity_factor=0.5)
    elif variant == "experts8":
        cfg = cfg.replace(n_experts=8, top_k=4)
    elif variant == "whole_leaves":
        cfg = cfg.replace(d_model=96)
    elif variant == "two_reps":
        cfg = cfg.replace(n_rep=2, n_layers=2 * len(cfg.pattern))
    elif variant == "odd_vocab":
        cfg = cfg.replace(vocab_size=509, n_kv_heads=2)
    elif variant == "chunk4":
        cfg = cfg.replace(ssm_chunk=4)
    elif variant != "base":
        raise ValueError(f"unknown variant {variant!r}")
    return cfg


def tp_batch(cfg, seed: int, b: int = None, s: int = None) -> dict:
    """A prompt of ``b`` rows (``TP_B``) of ``s`` positions (``TP_S``) in
    ``steps.token_batch``'s layout, numpy, from ``seed``: tokens (B, S),
    (B, K, S) for the codebooks, or (B, S - n_patches) beside f32
    ``patch_embeds`` for the vision arch."""
    b, s = b or TP_B, s or TP_S
    rng = np.random.RandomState(seed)
    if cfg.frontend == "audio_codebooks":
        return {"tokens": rng.randint(0, cfg.vocab_size, (b, cfg.n_codebooks, s))
                .astype(np.int32)}
    if cfg.frontend == "vision_stub":
        toks = rng.randint(0, cfg.vocab_size, (b, s - cfg.n_patches)).astype(np.int32)
        return {"tokens": toks, "patch_embeds": rng.randn(
            b, cfg.n_patches, cfg.d_vision).astype(np.float32)}
    return {"tokens": rng.randint(0, cfg.vocab_size, (b, s)).astype(np.int32)}


def tp_decode_batch(cfg, tokens) -> dict:
    """The next decode batch (numpy) from greedy tokens (B, 1), or (B, 1, K)
    for the codebooks; the vision arch's holds 0 patches."""
    tokens = np.asarray(tokens, np.int32)
    if cfg.frontend == "audio_codebooks":
        return {"tokens": np.ascontiguousarray(np.swapaxes(tokens, 1, 2))}
    if cfg.frontend == "vision_stub":
        return {"tokens": tokens,
                "patch_embeds": np.zeros((tokens.shape[0], 0, cfg.d_vision), np.float32)}
    return {"tokens": tokens}


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


def _gather_reversed(x, tp):
    """A planted fault: the SSM conv output gathered over its channels in
    the reverse rank order."""
    import torch

    from repro_torch.models import parallel

    return torch.cat(parallel.gather(x, tp, -1).chunk(tp.size, -1)[::-1], dim=-1)


def _owner_write_without_scale(cache, name, slot, new, lo=None):
    """A planted fault: ``attention._store_token`` writing an int8 cache's
    quantised values but not their scales."""
    from repro_torch.models import attention

    qv, _ = attention._quantize(new)
    (attention._write_slot if lo is None else
     lambda buf, s, v: attention._write_owned(buf, s, v, lo))(cache[name], slot, qv)


def tpa_faults():
    """The planted faults of the archs' tensor-parallel serving: name ->
    (its case of ``TPA_CASES``, module, attribute, the faulty
    replacement).  The codebook embeddings summed on each rank before one
    all-reduce are only a reordering of the same f32 additions (it holds
    at rtol = atol = 1e-5), so the codebook fault planted is the lookup
    without this rank's vocab offset."""
    import dataclasses

    from repro_torch.models import attention, parallel, ssm

    embed = parallel.vocab_embed
    return {
        "moe_sum_dropped": ("granite-moe", parallel, "sum_f32", lambda x, tp: x),
        "ssm_norm_rank_local": ("mamba2-2.7b", parallel, "rms_noscale",
                                lambda x, tp, whole, eps=1e-6: ssm.rmsnorm_noscale(x, eps)),
        "ssm_gather_reversed": ("mamba2-2.7b", ssm, "_gather_channels", _gather_reversed),
        "int8_write_without_scale": ("musicgen-large", attention, "_store_token",
                                     _owner_write_without_scale),
        "codebook_offset_dropped": ("musicgen-large", parallel, "vocab_embed",
                                    lambda tokens, emb, tp, vocab: embed(
                                        tokens, emb, dataclasses.replace(tp, rank=0), vocab)),
    }


def tp_cases(suite: str) -> dict:
    """A serving suite's cases: "dense" (``TP_CASES``) or "archs"
    (``TPA_CASES``)."""
    return {"dense": TP_CASES, "archs": TPA_CASES}[suite]


def tp_suite_faults(suite: str) -> dict:
    """A serving suite's planted faults: name -> (case, module, attribute,
    replacement); "dense": every fault of ``tp_faults`` on
    ``TP_FAULT_CASE``."""
    if suite == "dense":
        return {f: (TP_FAULT_CASE, *v) for f, v in tp_faults().items()}
    return tpa_faults()


def tp_whole(ref, suite: str) -> dict:
    """The port's whole-model outputs on the reference's params and inputs,
    per case of ``suite``: the prefill step's logits, ``prefill_with_
    caches``'s and its caches' leaves, and each decode step's logits
    (teacher-forced on the reference's inputs)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tf
    from repro_torch.utils.pytree import tree_leaves
    from repro_torch.weights import params_from_jax

    out = {}
    shape = InputShape("tp_serve", TP_CAPACITY, TP_B, "prefill")
    for name, (arch, variant) in tp_cases(suite).items():
        cfg, r = tp_config(get_config, arch, variant), ref[name]
        params = params_from_jax(r["params"], device="cpu")
        batch = _torch_batch(r["prompt"])
        step = steps.make_prefill_step(cfg, shape)(params, batch)
        logits, caches = tf.prefill_with_caches(params, cfg, batch, TP_CAPACITY)
        leaves = [leaf_np(x) for x in tree_leaves(caches)]
        decoded = []
        for t in range(TP_T):
            lg, caches = tf.decode_step(params, cfg, _torch_batch(r["inputs"][t]), TP_S + t,
                                        caches)
            decoded.append(lg.numpy())
        out[name] = {"prefill_step": step.numpy(), "prefill": logits.numpy(),
                     "caches": leaves, "decode": decoded}
    return out


def leaf_np(x):
    """A tensor as numpy, bit for bit (a bf16 leaf as its int16 bits)."""
    import torch

    return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy().copy()


def _torch_batch(batch: dict) -> dict:
    import torch

    return {k: torch.from_numpy(v) for k, v in batch.items()}


def tp_serve(rank, world, plan):
    """Tensor-parallel serving on ``plan["mesh"]``, per case of
    ``plan["suite"]`` (``tp_cases``; "dense" when absent), from the params
    and prompt of the JAX reference (``plan["ref"]``, pickled by
    ``tests/tp_serve_reference.py``): the prefill step's logits (whole),
    ``prefill_with_caches``'s logits and each decode step's (this data
    rank's rows, gathered over the vocab), teacher-forced on the
    reference's inputs, and the serve step's tokens (whole); with this
    rank's rows, the leaves of the caches its prefill left and the census
    of the two steps.  With ``plan["faults"]``, the same for each planted
    fault's case under that fault."""
    import pickle

    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import collectives, steps
    from repro_torch.launch.mesh import parse_mesh
    from repro_torch.launch.sharding import rank_plan
    from repro_torch.models import parallel
    from repro_torch.models import transformer as tf
    from repro_torch.utils.pytree import tree_leaves, tree_map
    from repro_torch.weights import cut, params_from_jax

    tp = steps.tensor_parallel(parse_mesh(plan["mesh"]))
    suite = plan.get("suite", "dense")
    cases = tp_cases(suite)
    with open(plan["ref"], "rb") as f:
        ref = pickle.load(f)
    shape = InputShape("tp_serve", TP_CAPACITY, TP_B, "prefill")
    out = {"argmax": _argmax_ties(tp), "cases": {}, "faults": {}}

    def rows(batch):
        batch = _torch_batch(batch)
        return cut(batch, rank_plan(batch, "batch", tp.data_size, drank=tp.data_rank))

    def vocab(logits, cfg):
        return parallel.gather(logits, tp, -1) if logits.shape[-1] != cfg.vocab_size else logits

    def serve_case(name):
        arch, variant = cases[name]
        cfg, r = tp_config(get_config, arch, variant), ref[name]
        whole = params_from_jax(r["params"], device="cpu")
        params = cut(whole, rank_plan(whole, "params", tp.data_size, tp.size, tp.data_rank,
                                      tp.rank))
        batch = rows(r["prompt"])
        collectives.reset_census()
        step_logits = steps.make_prefill_step(cfg, shape, tp)(params, batch)
        census = {"prefill_step": collectives.census()}
        logits, caches = tf.prefill_with_caches(params, cfg, batch, TP_CAPACITY, tp)
        prefilled = [leaf_np(x) for x in tree_leaves(caches)]
        serve = steps.make_serve_step(cfg, shape, tp)
        decoded, served = [], []
        for t in range(TP_T):
            tok = rows(r["inputs"][t])
            pos = torch.tensor(TP_S + t, dtype=torch.int32)
            collectives.reset_census()
            # on a copy: an SSM layer's recurrence steps its state in place
            tokens, _ = serve(params, tok, pos, tree_map(torch.clone, caches))
            census.setdefault("serve_step", collectives.census())
            step, caches = tf.decode_step(params, cfg, tok, pos, caches, tp)
            decoded.append(vocab(step, cfg).numpy())
            served.append(tokens.numpy())
        n = batch["tokens"].shape[0]
        return {"rows": (tp.data_rank * n, (tp.data_rank + 1) * n) if n < TP_B else (0, TP_B),
                "prefill_step": step_logits.numpy(), "prefill": vocab(logits, cfg).numpy(),
                "caches": prefilled, "decode": decoded, "serve": served, "census": census}

    for name in cases:
        out["cases"][name] = serve_case(name)
    faults = tp_suite_faults(suite) if plan.get("faults") else {}
    for fault, (case, module, attr, faulty) in faults.items():
        sound = getattr(module, attr)
        setattr(module, attr, faulty)
        try:
            out["faults"][fault] = serve_case(case)
        finally:
            setattr(module, attr, sound)
    return out


def serve_cli(rank, world, argv):
    """``launch/serve.py``'s CLI on this rank (the group is already up)."""
    from repro_torch.launch import serve

    return serve.main(argv)


# tests/test_torch_seqshard.py: the sequence-parallel prefill's cases,
# shared with its JAX reference (tests/seqshard_reference.py)
SQ_B, SQ_S = 4, 24  # batch, prompt: S/m = 12 at m = 2, 6 at m = 4
SQ_CASES = {  # name -> (arch, variant[, prompt length, SQ_S if not given]): tp_config's
    "gemma3-1b": ("gemma3-1b", "base"),  # window 512 (> S) and full
    "gemma3-1b/wrap": ("gemma3-1b", "wrap"),  # window 8: below S/m at m = 2, above at 4
    "gemma2-9b/wrap": ("gemma2-9b", "wrap"),  # and the softcaps
    "granite-3-2b": ("granite-3-2b", "base"),
    "granite-3-8b": ("granite-3-8b", "base"),
    "granite-moe": ("granite-moe-1b-a400m", "base"),
    "granite-moe/odd_vocab": ("granite-moe-1b-a400m", "odd_vocab"),  # embed whole
    "olmoe-1b-7b": ("olmoe-1b-7b", "experts8"),
    # the capacity dispatches at capacity factor 0.5: slots are dropped
    "granite-moe/dispatch": ("granite-moe-1b-a400m", "dispatch"),
    "granite-moe/dispatch_grouped": ("granite-moe-1b-a400m", "dispatch_grouped"),
    "mamba2-2.7b": ("mamba2-2.7b", "chunk4"),  # 3 chunks a rank at m = 2 and 4
    "mamba2-2.7b/halo": ("mamba2-2.7b", "chunk4", 8),  # S/m = 2 < w - 1 at m = 4
    "zamba2-2.7b": ("zamba2-2.7b", "two_reps"),
    "internvl2-2b": ("internvl2-2b", "base"),  # 8 patches: ranks 0 and 1 at m = 4
    "musicgen-large": ("musicgen-large", "base"),
}
# the planted faults' cases: the arch a fault of scripts/seqshard_faults.py
# is read on (its ARCH) -> the case run under it
SQ_FAULT_CASES = {"gemma3-1b": "gemma3-1b/wrap", "zamba2-2.7b": "zamba2-2.7b",
                  "internvl2-2b": "internvl2-2b", "musicgen-large": "musicgen-large",
                  "granite-moe-1b-a400m/dispatch": "granite-moe/dispatch"}


def sq_config(get, name: str):
    """The reduced config of ``SQ_CASES[name]`` (``get``: either package's
    ``get_config``) with ``seq_shard`` set."""
    return tp_config(get, *SQ_CASES[name][:2]).replace(seq_shard=True)


def sq_len(name: str) -> int:
    """The prompt length of ``SQ_CASES[name]``, patches included."""
    return (SQ_CASES[name] + (SQ_S,))[2]


def sq_prompt(cfg, seed: int, s: int = SQ_S) -> dict:
    """A prompt of ``s`` positions a row (patches included), ``SQ_B``
    rows, numpy, from ``seed``: ``tp_batch``'s layout."""
    return tp_batch(cfg, seed, SQ_B, s)


def sq_fault_case(fault: str) -> str:
    """The case a planted fault of ``sq_faults`` is read on."""
    return SQ_FAULT_CASES[_sq_fault_module().ARCH[fault]]


def _sq_fault_module():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "scripts" / "seqshard_faults.py"
    spec = importlib.util.spec_from_file_location("seqshard_faults", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sq_faults():
    """The planted faults of the sequence-parallel prefill
    (``scripts/seqshard_faults.py``, which ``chip_smoke.py`` phase 20 also
    plants): name -> (module, attribute, the faulty replacement)."""
    return _sq_fault_module().faults()


def sq_prefill(rank, world, plan):
    """The sequence-parallel prefill step on ``plan["mesh"]``, per case of
    ``SQ_CASES``, from the JAX reference's inputs (``plan["ref"]``): this
    rank's params cut by ``rank_plan(seqshard=True)``, its data rank's rows
    of the prompt; the step's logits (whole), its census and which leaves
    the plan cut.  With ``plan["faults"]``, the logits of each planted
    fault of ``sq_faults`` on its case (``sq_fault_case``)."""
    import pickle

    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import collectives, steps
    from repro_torch.launch.mesh import parse_mesh
    from repro_torch.launch.sharding import rank_plan
    from repro_torch.utils.pytree import keystr, tree_flatten_with_path
    from repro_torch.weights import cut, params_from_jax

    tp = steps.tensor_parallel(parse_mesh(plan["mesh"]))
    with open(plan["ref"], "rb") as f:
        ref = pickle.load(f)
    def case(name):
        cfg = sq_config(get_config, name)
        shape = InputShape("seqshard", sq_len(name), SQ_B, "prefill")
        whole = params_from_jax(ref[name]["params"], device="cpu")
        pplan = rank_plan(whole, "params", tp.data_size, tp.size, tp.data_rank, tp.rank,
                          seqshard=True)
        batch = _torch_batch(ref[name]["prompt"])
        batch = cut(batch, rank_plan(batch, "batch", tp.data_size, drank=tp.data_rank))
        collectives.reset_census()
        logits = steps.make_prefill_step(cfg, shape, tp)(cut(whole, pplan), batch)
        return {"logits": logits.numpy(), "census": collectives.census(),
                "cut": sorted(keystr(p) for p, x in tree_flatten_with_path(pplan) if x.cuts)}

    out = {"cases": {name: case(name) for name in SQ_CASES}, "faults": {}}
    for fault, (module, attr, faulty) in (sq_faults().items() if plan.get("faults") else ()):
        sound = getattr(module, attr)
        setattr(module, attr, faulty)
        try:
            out["faults"][fault] = case(sq_fault_case(fault))["logits"]
        finally:
            setattr(module, attr, sound)
    return out


# tests/test_torch_tp_train.py: the tensor-parallel train step's cases,
# shared with its JAX reference (tests/tp_train_reference.py)
TT_B, TT_S, TT_T = 2, 16, 2  # micro batch, sequence, local iterations
TT_PCFG = dict(eta1=0.5, eta2=0.1)  # a round-start step large enough to read
# the client's and the server's deltas, and the params' offset: |dp|^2 ~ 1
# at the cases' ~1e6 parameters, where the round start's coeff = 1 - |dp|^2 /
# (1 + |dp|^2) reads its sums (at |dp|^2 >> 1 it cancels to a few f32 ulps)
TT_NOISE = 1e-3
TT_CASES = {  # name -> (arch, variant): tp_config's, so every rule splits
    "gemma3-1b": ("gemma3-1b", "base"),
    "gemma3-1b/head_dim": ("gemma3-1b", "head_dim"),
    "gemma2-9b": ("gemma2-9b", "base"),
    "granite-3-2b": ("granite-3-2b", "base"),
    "granite-3-8b": ("granite-3-8b", "base"),
    "granite-moe": ("granite-moe-1b-a400m", "base"),
    "granite-moe/dispatch": ("granite-moe-1b-a400m", "dispatch"),
    "olmoe-1b-7b": ("olmoe-1b-7b", "experts8"),
    "mamba2-2.7b": ("mamba2-2.7b", "base"),
    "mamba2-2.7b/whole_leaves": ("mamba2-2.7b", "whole_leaves"),
    "zamba2-2.7b": ("zamba2-2.7b", "two_reps"),
}


def _tt_ce_local(logits, labels, tp):
    """A planted fault: the vocab-parallel CE with its logsumexp over this
    rank's slice only."""
    import torch

    from repro_torch.models import parallel

    logits = logits.float()
    n = logits.shape[-1]
    top = logits.amax(-1).detach()
    se = torch.exp(logits - top[..., None]).sum(-1)
    local = labels.long() - tp.rank * n
    inside = (local >= 0) & (local < n)
    gold = logits.gather(-1, local.clamp(0, n - 1)[..., None])[..., 0]
    gold = parallel.reduce(torch.where(inside, gold, torch.zeros_like(gold)), tp)
    return (torch.log(se) + top - gold).mean()


def _tt_rms_noscale_local(x, tp, whole, eps=1e-6):
    """A planted fault: ``parallel.rms_noscale`` whose statistic's backward
    keeps this rank's heads' share (no ``enter`` after the all-reduce)."""
    import torch

    from repro_torch.models import parallel

    x32 = x.float()
    ss = parallel.reduce((x32 * x32).sum(dim=-1, keepdim=True), tp)
    return (x32 * torch.rsqrt(ss / whole + eps)).to(x.dtype)


def _tt_per_head_local(p, hs, tp):
    """A planted fault: ``ssm._per_head`` reading the SSM's per-head leaves
    on this rank's heads without ``enter``: their gradient rank-local."""
    if hs is None:
        return p["dt_bias"], p["A_log"], p["D"]
    return p["dt_bias"][hs], p["A_log"][hs], p["D"][hs]


def tt_faults():
    """The planted faults of the tensor-parallel train step: name -> (its
    case of ``TT_CASES``, module, attribute, the faulty replacement)."""
    import dataclasses

    from repro_torch.core import pfedsop
    from repro_torch.models import attention, moe, parallel, ssm

    personalize = pfedsop._personalize_tp
    return {
        "attention_input_enter_dropped": ("gemma3-1b", attention, "_block_input",
                                          lambda x, tp: x),
        "kv_gather_backward_a_plain_slice": ("gemma3-1b", attention, "_whole_kv",
                                             lambda k, v, tp: (k, v)),
        "ce_logsumexp_local": ("gemma3-1b", parallel, "cross_entropy", _tt_ce_local),
        # every rank taking itself for rank 0: the replicated leaves counted m times
        "round_start_counts_replicated_on_every_rank": (
            "gemma3-1b", pfedsop, "_personalize_tp",
            lambda params, ld, gd, cfg, impl, tp, split: personalize(
                params, ld, gd, cfg, impl, dataclasses.replace(tp, rank=0), split)),
        "moe_gates_rank_local": ("granite-moe", moe, "_gates", lambda w, tp: w),
        "ssm_norm_statistic_backward_local": ("zamba2-2.7b", parallel, "rms_noscale",
                                              _tt_rms_noscale_local),
        "ssm_per_head_leaves_rank_local": ("zamba2-2.7b", ssm, "_per_head",
                                           _tt_per_head_local),
    }


def _digest(x) -> str:
    import hashlib

    return hashlib.sha1(leaf_np(x.contiguous()).tobytes()).hexdigest()


def tt_step(cfg, ref_case, tp=None, chunks=1):
    """``make_train_step`` on a reference case's inputs (``tests/
    tp_train_reference.py``): with ``tp`` on this rank's slices of the
    state and the global delta.  Returns (state', global delta', loss,
    the state's plan, the global delta's plan); the plans are None
    without ``tp``."""
    from repro_torch.configs.base import InputShape
    from repro_torch.core.pfedsop import PFedSOPConfig
    from repro_torch.kernels.dispatch import grad_chunk_count
    from repro_torch.launch import steps
    from repro_torch.launch.sharding import rank_plan
    from repro_torch.weights import cut, params_from_jax

    state = params_from_jax(ref_case["state"], device="cpu")
    gd = params_from_jax(ref_case["gd"], device="cpu")
    batches = _torch_batch(ref_case["batches"])
    splan = gplan = None
    if tp is not None:
        splan = {k: rank_plan(v, "params", 1, tp.size, 0, tp.rank, client=True)
                 for k, v in state.items()}
        gplan = rank_plan(gd, "params", 1, tp.size, 0, tp.rank)
        state, gd = cut(state, splan), cut(gd, gplan)
    shape = InputShape("tp_train", TT_S, TT_B * TT_T, "train")
    step = steps.make_train_step(cfg, shape, PFedSOPConfig(**TT_PCFG), tp=tp)
    with grad_chunk_count(chunks):
        new_state, new_gd, loss = step(state, gd, batches)
    return new_state, new_gd, loss, splan, gplan


def tt_round_start(cfg, ref_case, tp=None):
    """The round start's (beta, eta1 * coeff) on a reference case's client:
    with ``tp``, ``tree_personalize`` on this rank's slices; without, the
    plain K1 over the whole flat vectors and the same scalars."""
    from repro_torch.core import pfedsop as pf
    from repro_torch.kernels.pfedsop_update import ops
    from repro_torch.launch import steps
    from repro_torch.launch.sharding import rank_plan
    from repro_torch.utils.pytree import FlatLayout, tree_map
    from repro_torch.weights import cut, params_from_jax

    pcfg = pf.PFedSOPConfig(**TT_PCFG)
    trees = [params_from_jax(tree_map(lambda x: x[0], ref_case["state"][k]) if k else
                             ref_case["gd"], device="cpu") for k in ("params", "delta", None)]
    if tp is None:
        layout = FlatLayout(trees[0])
        dv, gv = layout.flatten(trees[1]), layout.flatten(trees[2])
        beta, eta_coeff = ops.scalars_from_partials(ops.reduce3_batched_plain(dv[None], gv),
                                                    pcfg.eta1, pcfg.rho, pcfg.lam, pcfg.eps)
        return float(beta[0]), float(eta_coeff[0])
    plan = rank_plan(trees[0], "params", 1, tp.size, 0, tp.rank)
    trees = [cut(t, plan) for t in trees]
    _, aux = pf.tree_personalize(*trees, pcfg, tp=tp, split=steps.split_leaves(cfg, tp))
    return float(aux["beta"]), float(aux["eta_coeff"])


def tt_whole(ref) -> dict:
    """The port's one-rank step per case of ``TT_CASES`` on the reference's
    inputs: {chunks: (state', global delta', loss)} as numpy leaves at
    ``grad_chunks`` 1, and for the MoE at 2 (a data axis of 2's reference:
    the other archs' chunk mean is the batch's), and the round start's
    scalars under "round_start"."""
    from repro_torch.configs import get_config
    from repro_torch.utils.pytree import tree_leaves

    out = {}
    for name, (arch, variant) in TT_CASES.items():
        cfg = tp_config(get_config, arch, variant)
        out[name] = {"round_start": tt_round_start(cfg, ref[name])}
        for chunks in (1, 2)[:1 + (cfg.n_experts > 0)]:
            s, g, loss, _, _ = tt_step(cfg, ref[name], chunks=chunks)
            out[name][chunks] = ([leaf_np(x) for x in tree_leaves(s)],
                                 [leaf_np(x) for x in tree_leaves(g)], float(loss))
    return out


def tp_train(rank, world, plan):
    """The tensor-parallel train step on ``plan["mesh"]``, per case of
    ``TT_CASES``, from the JAX reference's inputs (``plan["ref"]``):
    rank 0 returns the outputs made whole (numpy leaves: state', global
    delta', loss); every rank the digests of its loss and of every
    replicated leaf of its outputs (all ranks must agree), the round
    start's (beta, eta1 * coeff) on its slices, and, where the
    mesh has a data axis, whether the step equals the model-only step at
    ``grad_chunks`` equal to the data size bit for bit.  With
    ``plan["faults"]``, the same under each planted fault of
    ``tt_faults``."""
    import dataclasses
    import pickle

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import collectives, steps
    from repro_torch.launch.mesh import parse_mesh
    from repro_torch.utils.pytree import tree_leaves
    from repro_torch.weights import join

    tp = steps.tensor_parallel(parse_mesh(plan["mesh"]))
    with open(plan["ref"], "rb") as f:
        ref = pickle.load(f)

    def gather(x, dim):
        return collectives.all_gather(x, tp.group, dim=dim)

    def case(name):
        arch, variant = TT_CASES[name]
        cfg = tp_config(get_config, arch, variant)
        s, g, loss, splan, gplan = tt_step(cfg, ref[name], tp)
        outs = []
        for tree, p in ((s, splan), (g, gplan)):
            outs.append([leaf_np(x) for x in tree_leaves(join(tree, p, gather))])
        replicated = [_digest(x) for t, p in ((s, splan), (g, gplan))
                      for x, q in zip(tree_leaves(t), tree_leaves(p)) if not q.cuts]
        got = {"whole": (*outs, float(loss)) if rank == 0 else None,
               "digests": [_digest(loss)] + replicated,
               "round_start": tt_round_start(cfg, ref[name], steps._model_only(tp))}
        if tp.data_size > 1:  # the data split against in-body chunks on the model group
            s2, g2, loss2, _, _ = tt_step(cfg, ref[name], dataclasses.replace(
                tp, data_group=None, data_size=1, data_rank=0), chunks=tp.data_size)
            got["data_split_bitwise"] = all(
                torch.equal(a, b) for a, b in zip(tree_leaves((s, g, loss)),
                                                   tree_leaves((s2, g2, loss2))))
        return got

    out = {"cases": {name: case(name) for name in TT_CASES}, "faults": {}}
    for fault, (name, module, attr, faulty) in (tt_faults().items()
                                                if plan.get("faults") else ()):
        sound = getattr(module, attr)
        setattr(module, attr, faulty)
        try:
            out["faults"][fault] = case(name)
        finally:
            setattr(module, attr, sound)
    return out


def train_cli(rank, world, argv):
    """``launch/train.py``'s CLI on this rank (the group is already up)."""
    from repro_torch.launch import train

    return train.main(argv)


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
