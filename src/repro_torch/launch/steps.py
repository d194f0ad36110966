"""Step definitions: the port of ``repro/launch/steps.py``.

The pFedSOP train step (the paper's Algorithm 3 over a leading client axis):

  per client (the loop form of a federation engine's client phase,
  ``fl/engine.py``: one client after another):
    1. personalize: Gompertz-weighted aggregation of (local delta, global
       delta) + Sherman-Morrison FIM step  (``core/pfedsop.py::
       tree_personalize``: one C = 1 launch pair of K1/K2 on the card, on
       this rank's tile range inside a model-split mesh)
    2. T local SGD iterations, one per microbatch (``optim/sgd.py::
       tree_sgd_loop``; ``grad_chunks`` chunks a step, in the body or one
       per rank of a mesh's data axis)
    3. new local delta = (x0 - xT) / eta2
  server:
    4. global delta = the canonical cohort mean over the client axis (Eq. 13)

  With ``tp`` it is one rank's Megatron program on its model slices
  (``make_train_step``): ``launch/train.py``'s replicated step on a model
  axis.

Serving:
  make_prefill_step  full forward, last-position logits
  make_serve_step    one new token against the KV caches; greedy sampling
                     (``argmax``: ties go to the first index, as in JAX)

  With ``tp`` (a ``models/parallel.py`` ``TensorParallel``) each is one
  rank's program of ``repro``'s GSPMD-partitioned step: params cut to this
  model rank's slices, the batch to this data rank's rows (where the data
  size divides the batch) and the caches to both (``launch/sharding.py::
  rank_plan``, ``weights.cut``).  The outputs are whole on every rank, as
  ``repro``'s replicated ``out_shardings`` make them: the prefill's logits
  all-gathered over the vocab slices and the data ranks' rows, the serve
  step's tokens from ``parallel.vocab_argmax`` over the last dim (the
  codebooks' (B, 1, K, V/m) logits too) and all-gathered over the data
  ranks; the caches stay this rank's slices.  Every arch serves so; the
  vision arch's ``patch_embeds`` are cut to the data rank's rows like the
  tokens.  Where the data size does not divide the batch, every data
  rank holds the whole batch and the step drops the data group.  With
  no ``tp`` they are the one-device steps.

  ``cfg.seq_shard`` (``repro``'s ``seqshard`` variant): the prefill step
  with ``tp`` is one rank's sequence-parallel program
  (``models/transformer.py``'s module docstring): params with every layer
  leaf whole and ``embed`` vocab-cut (``rank_plan(seqshard=True)``), the
  data rank's rows of the whole prompt; the last position broadcast from
  the last model rank, its logits gathered over the vocab and the data
  ranks as above.  The serve step ignores the flag, as ``repro``'s decode
  does (its caches and params keep the tensor-parallel layout).  Every
  arch and MoE impl takes the flag (``transformer.check_seq_shard``
  refuses only a config without a decoder stack, when the prefill step
  is made); the frontends' batches are the whole prompt's (the vision
  arch's patches count among the S positions), the codebook heads'
  (B, 1, K, V/m) logits gathered over the vocab like ``embed``'s.

``input_specs(cfg, shape)`` builds meta-device stand-ins for every input,
leaf for leaf ``repro``'s ``ShapeDtypeStruct``s (a leading client axis on
the per-client inputs): no allocation, no draw.  ``abstract_params`` and
``abstract_caches`` are the model's trees on the meta device.  The batch
layouts per modality frontend (``repro``'s ``_token_batch`` /
``_decode_batch``) are ``{name: (shape, dtype)}`` specs.

The serving steps take the unbatched tree of one client; the train step
takes the client axis: one client per pod rank on ``pods:PxDxM``, 1 on a
single pod (``make_train_step``'s ``engine``).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core import pfedsop as pf
from repro_torch.fl.engine import VmapBackend
from repro_torch.kernels.dispatch import data_shard_axis
from repro_torch.launch import collectives
from repro_torch.launch.mesh import resolve_mesh
from repro_torch.launch.sharding import rank_plan
from repro_torch.models import parallel
from repro_torch.models import transformer as tf
from repro_torch.models.transformer import apply_long_context
from repro_torch.optim.reduce import cohort_mean
from repro_torch.optim.sgd import tree_sgd_loop
from repro_torch.utils.pytree import tree_leaves, tree_map

MICRO_BATCH = 32  # per-SGD-iteration batch for train_4k (T = 256/32 = 8)
META = torch.device("meta")


def resolve_cfg(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """The config a shape runs: ``long_500k`` caps every attention window
    (``apply_long_context``)."""
    if shape.name == "long_500k":
        return apply_long_context(cfg)
    return cfg


def token_batch(cfg: ModelConfig, b: int, s: int) -> dict:
    """A training / prefill batch of ``s`` positions: tokens and labels
    (B, S), or (B, K, S) for the codebooks; the vision frontend's
    ``n_patches`` of the ``s`` positions are patch embeddings."""
    i32 = torch.int32
    if cfg.frontend == "audio_codebooks":
        return {"tokens": ((b, cfg.n_codebooks, s), i32),
                "labels": ((b, cfg.n_codebooks, s), i32)}
    if cfg.frontend == "vision_stub":
        s_text = s - cfg.n_patches
        return {"tokens": ((b, s_text), i32), "labels": ((b, s_text), i32),
                "patch_embeds": ((b, cfg.n_patches, cfg.d_vision), torch.float32)}
    return {"tokens": ((b, s), i32), "labels": ((b, s), i32)}


def decode_batch(cfg: ModelConfig, b: int) -> dict:
    """One decode step's batch: a token per sequence (per codebook), and
    for the vision frontend no patches."""
    i32 = torch.int32
    if cfg.frontend == "audio_codebooks":
        return {"tokens": ((b, cfg.n_codebooks, 1), i32)}
    if cfg.frontend == "vision_stub":
        return {"tokens": ((b, 1), i32),
                "patch_embeds": ((b, 0, cfg.d_vision), torch.float32)}
    return {"tokens": ((b, 1), i32)}


def next_tokens(cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """``make_serve_step``'s tokens (B, 1), or (B, 1, K) for the codebooks,
    as the next decode batch's ``tokens`` (B, 1) / (B, K, 1)."""
    return tokens.transpose(1, 2) if cfg.frontend == "audio_codebooks" else tokens


def tensor_parallel(spec, mesh=None) -> parallel.TensorParallel:
    """This rank's ``TensorParallel`` on ``spec``'s model and data axes, over
    the default process group laid out by ``launch/mesh.py::resolve_mesh``
    (or ``mesh``, one already laid out)."""
    mesh = mesh if mesh is not None else resolve_mesh(spec)

    def axis(name):
        if name is None or spec.size(name) == 1:
            return None, 1, 0
        return mesh.get_group(name), spec.size(name), mesh.get_local_rank(name)

    group, size, rank = axis(spec.model_axis)
    data_group, data_size, data_rank = axis(spec.data_axis)
    return parallel.TensorParallel(group, size, rank, data_group, data_size, data_rank)


def _for_batch(tp: Optional[parallel.TensorParallel], shape: InputShape):
    """``tp`` for ``shape``'s batch: without its data group where the data
    size does not divide the batch (every data rank then holds all of it,
    as the rules replicate it)."""
    if tp is None or tp.data_size == 1 or shape.global_batch % tp.data_size == 0:
        return tp
    return dataclasses.replace(tp, data_group=None, data_size=1, data_rank=0)


def _whole_rows(x, tp: Optional[parallel.TensorParallel]):
    """Every data rank's rows of ``x``, where the data size split the batch."""
    if tp is None or tp.data_size == 1:
        return x
    return collectives.all_gather(x, tp.data_group, dim=0)


def make_prefill_step(cfg: ModelConfig, shape: InputShape,
                      tp: Optional[parallel.TensorParallel] = None):
    cfg = resolve_cfg(cfg, shape)
    tp = _for_batch(tp, shape)
    if cfg.seq_shard:
        tf.check_seq_shard(cfg)

    @torch.no_grad()
    def prefill_step(params, batch):
        hidden, _ = tf.forward(params, cfg, batch, tp=tp)
        logits = tf.lm_logits(params, cfg, tf.last_position(hidden, cfg, tp), tp=tp)
        if tp is not None and parallel.split(tp, logits.shape[-1], cfg.vocab_size):
            logits = parallel.gather(logits, tp, -1)
        return _whole_rows(logits, tp)

    return prefill_step


def make_serve_step(cfg: ModelConfig, shape: InputShape,
                    tp: Optional[parallel.TensorParallel] = None):
    cfg = resolve_cfg(cfg, shape)
    tp = _for_batch(tp, shape)

    def serve_step(params, batch, pos, caches):
        """-> (next tokens (B, 1), or (B, 1, K) for the codebooks, int32;
        caches updated in place)."""
        logits, caches = tf.decode_step(params, cfg, batch, pos, caches, tp=tp)
        if tp is None:
            return logits.argmax(-1).to(torch.int32), caches
        tokens = parallel.vocab_argmax(logits, tp, cfg.vocab_size).to(torch.int32)
        return _whole_rows(tokens, tp), caches

    return serve_step


# ---------------------------------------------------------------------------
# Meta-device input builders
# ---------------------------------------------------------------------------


class _OnMeta(TorchDispatchMode):
    """Every op that names a device runs on the meta device instead: the
    initializers' draws (``torch.randn(..., generator=g, device=g.device)``)
    make meta tensors of their shape and dtype and draw nothing."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if "device" in kwargs:
            kwargs["device"] = META
        return func(*args, **kwargs)


def _meta_leaves(specs: dict) -> dict:
    return {k: torch.empty(shape, dtype=dtype, device=META) for k, (shape, dtype) in specs.items()}


def abstract_params(cfg: ModelConfig) -> Any:
    """``tf.init_params``'s tree on the meta device (a full olmoe-1b-7b tree
    is 6.8 G elements, which a draw on the CPU cannot afford)."""
    with _OnMeta():
        return tf.init_params(torch.Generator(), cfg, device=META)


def abstract_caches(cfg: ModelConfig, batch: int, seq_len: int) -> Any:
    """``tf.init_caches``'s tree on the meta device."""
    return tf.init_caches(cfg, batch, seq_len, device=META)


def _stack_client(tree, n_clients: int):
    """A new meta tree whose leaves lead with the client axis."""
    return tree_map(lambda x: torch.empty((n_clients,) + tuple(x.shape), dtype=x.dtype,
                                          device=META), tree)


def input_specs(cfg: ModelConfig, shape: InputShape, n_clients: int = 1,
                micro_batch: int = MICRO_BATCH,
                t_override: Optional[int] = None) -> Dict[str, Any]:
    """Meta-device stand-ins for the step inputs of (arch x shape), each leaf
    its own storage.

    ``t_override`` pins the local-SGD iteration count (the roofline
    calibration counts T=1)."""
    cfg = resolve_cfg(cfg, shape)
    params = abstract_params(cfg)

    if shape.kind == "train":
        mb = min(micro_batch, shape.global_batch)
        t = t_override or max(1, shape.global_batch // mb)
        batches = {k: ((t,) + sh, dt) for k, (sh, dt) in
                   token_batch(cfg, mb, shape.seq_len).items()}
        return {
            "state": {"params": _stack_client(params, n_clients),
                      "delta": _stack_client(params, n_clients)},
            "global_delta": params,  # broadcast from the server
            "batches": _stack_client(_meta_leaves(batches), n_clients),
        }

    if shape.kind == "prefill":
        return {
            "params": _stack_client(params, n_clients),
            "batch": _stack_client(
                _meta_leaves(token_batch(cfg, shape.global_batch, shape.seq_len)), n_clients),
        }

    # decode
    caches = abstract_caches(cfg, shape.global_batch, shape.seq_len)
    return {
        "params": _stack_client(params, n_clients),
        "batch": _stack_client(_meta_leaves(decode_batch(cfg, shape.global_batch)), n_clients),
        "pos": torch.empty((), dtype=torch.int32, device=META),
        "caches": _stack_client(caches, n_clients),
    }


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------


def _model_only(tp: parallel.TensorParallel) -> parallel.TensorParallel:
    """``tp`` without its data group: a train step's data ranks each take
    a gradient chunk of their own (``optim/sgd.py``'s data split), so the
    model never routes over the data ranks' rows."""
    return dataclasses.replace(tp, data_group=None, data_size=1, data_rank=0)


def split_leaves(cfg: ModelConfig, tp: parallel.TensorParallel) -> list:
    """Per leaf of ``cfg``'s params (leaf order): whether this model rank
    holds a slice of it (``launch/sharding.py``'s rules)."""
    plan = rank_plan(abstract_params(cfg), "params", 1, tp.size, 0, tp.rank)
    return [bool(p.cuts) for p in tree_leaves(plan)]


def _data_rows(batches, tp: parallel.TensorParallel):
    """This data rank's contiguous chunk of every per-step batch (C, T, b,
    ...), or None where the data size does not divide ``b``."""
    b = tree_leaves(batches)[0].shape[2]
    if tp.data_size == 1 or b % tp.data_size:
        return None
    n = b // tp.data_size
    return tree_map(lambda x: x.narrow(2, tp.data_rank * n, n), batches)


def make_train_step(cfg: ModelConfig, shape: InputShape,
                    pcfg: Optional[pf.PFedSOPConfig] = None,
                    use_pfedsop: bool = True, engine=None,
                    tp: Optional[parallel.TensorParallel] = None):
    """Returns train_step(state, global_delta, batches) -> (state', gd', loss).

    ``state`` ({"params", "delta"}) and ``batches`` carry a leading client
    axis; ``global_delta`` is one tree.  ``use_pfedsop=False`` gives the
    plain-FedAvg round (no personalization).  The step reads nothing back to
    the host, so it runs on meta tensors too (``launch/dryrun.py``).

    ``engine`` (a ``fl/engine.py`` engine; ``VmapBackend`` when None) runs
    the client step through the loop form of its ``client_phase_sharded``
    and, when it splits the cohort over a client axis, Eq. 13 through its
    ``aggregate_phase``: the mesh code path the federation drivers run
    (``repro``'s ``make_train_step(engine=)``).  On a mesh the step returns
    this rank's client rows of ``state'`` (the whole cohort when the cohort
    is not split) and the same ``gd'`` and loss on every rank; both paths
    reduce with the halving-tree ``cohort_mean``, so they agree bit for bit
    (and with the engine-less step, over the same clients).

    This is a second client round beside ``core/pfedsop.py::
    tree_client_round``, which ``launch/train_lm_pfedsop.py::train`` runs.
    The two stay separate because their references differ: ``repro``'s
    ``make_train_step`` always personalizes and divides the f32 difference
    by eta2, while its federated LM loop skips the personalization until a
    client and the server hold a delta (a host-side choice) and multiplies
    the leaf-dtype difference by 1/eta2.  Each is held to its own
    reference (``tests/test_torch_dryrun.py``, ``tests/test_torch_lm.py``);
    the dry run and phases 15 and 17 of ``chip_smoke.py`` cover this one,
    and the driver's peak at C > 1 is not predicted by them.

    ``tp`` (a ``models/parallel.py`` ``TensorParallel``; no ``engine``):
    one rank's Megatron program of ``repro``'s jit-partitioned replicated
    step (``repro/launch/train.py``: the client state and the global delta
    sharded over ``model``).  ``state`` and ``global_delta`` hold this
    model rank's slices of the leaves the rules split
    (``launch/sharding.py::rank_plan``, ``weights.cut``) and the other
    leaves whole; the round start runs on them
    (``core/pfedsop.py::tree_personalize``'s ``tp``), the local steps
    through the tensor-parallel forward and backward
    (``models/transformer.py``'s ``tp``) and Eq. 13 on the slices, so the
    outputs are this rank's slices (the loss, and every replicated leaf,
    bitwise equal on every rank).  Where the data size divides the micro
    batch, each data rank takes its contiguous rows of every batch and
    the gradient chunks gather over the data group (``optim/sgd.py``'s
    data split): bitwise the step at data 1 and ``grad_chunks`` equal to
    the data size.  Text archs only, as ``repro``'s ``launch/train.py`` trains."""
    if engine is not None and not callable(getattr(engine, "client_phase_sharded", None)):
        raise TypeError(f"make_train_step(engine=...): {type(engine).__name__} is not a "
                        "federation engine (repro_torch.fl.engine)")
    if tp is not None and engine is not None:
        raise ValueError("make_train_step: a tensor-parallel step runs engine-less (tp= or "
                         "engine=, not both)")
    cfg = resolve_cfg(cfg, shape)
    if tp is not None and cfg.frontend != "none":
        raise NotImplementedError(
            f"a tensor-parallel train step of {cfg.name}: repro's launch/train.py trains text "
            "archs only (repro/launch/train.py:77-78), so the frontends have no train step to port")
    if tp is not None and cfg.seq_shard:
        raise NotImplementedError(
            "a sequence-parallel train step: repro's seqshard train lowering pins manual axes "
            "inside MeshBackend's shard_map, which does not lower (ROADMAP.md section 3, R7); "
            "the dry run's seqshard train record is the engine lowering")
    pcfg = pcfg or pf.PFedSOPConfig()
    engine = engine if engine is not None else VmapBackend()
    mtp = _model_only(tp) if tp is not None else None
    split = split_leaves(cfg, tp) if tp is not None else None

    def loss_fn(p, batch):
        return tf.lm_loss(p, cfg, batch, mtp)

    def client_step(state, global_delta, batches):
        params = state["params"]
        if use_pfedsop:
            params, _ = pf.tree_personalize(params, state["delta"], global_delta, pcfg,
                                            tp=mtp, split=split)
        final, loss = tree_sgd_loop(loss_fn, params, batches, pcfg.eta2)
        # repro's step divides the f32 difference by eta2, where
        # tree_local_sgd_delta (repro's local_sgd_delta, the federated LM
        # loop's) subtracts in the leaf dtype and multiplies by the
        # reciprocal: another rounding, so it is not reused here
        new_delta = tree_map(lambda a, b: ((a.float() - b.float()) / pcfg.eta2).to(a.dtype),
                             params, final)
        return {"params": final, "delta": new_delta}, {}, {"loss": loss}

    def server(global_delta_, deltas, losses):
        # Eq. 13's server aggregation: the canonical cohort mean, over the
        # ranks' rows in rank order inside ``aggregate_phase``
        new_global = tree_map(lambda d, m: m.to(d.dtype), deltas, cohort_mean(deltas))
        return new_global, cohort_mean(losses)

    def train_step(state, global_delta, batches, shardings=None):
        with contextlib.ExitStack() as ctx:
            rows = _data_rows(batches, tp) if tp is not None else None
            if rows is not None:  # the data split of the gradient chunks
                batches = rows
                ctx.enter_context(data_shard_axis(tp.data_group, tp.data_size))
            new_state, _, metrics = engine.client_phase_sharded(
                client_step, state, global_delta, batches, shardings=shardings, loop=True)
        if engine.client_sharded:
            new_global, loss = engine.aggregate_phase(server, global_delta,
                                                      new_state["delta"], metrics["loss"])
        else:  # the whole cohort on every rank
            new_global, loss = server(global_delta, new_state["delta"], metrics["loss"])
        return new_state, new_global, loss

    return train_step
