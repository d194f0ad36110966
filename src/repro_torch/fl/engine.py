"""Federation engines: where the per-client work of a round runs.

Port of ``repro/fl/engine.py``.  Three backends behind one interface:

  VmapBackend      one device: the round's K' clients are one
                   ``torch.func.vmap`` over the stacked client axis (the
                   reference semantics).
  MeshBackend      ranks of a ``torch.distributed`` process group laid out
                   as a ``launch/mesh.py`` ``MeshSpec`` (``pods:PxDxM``):
                   the cohort is split over the client-role axis in
                   contiguous rank-ordered slices and each rank vmaps its
                   local clients; the data and model axes replicate the
                   per-client phase, except the pFedSOP round-start update,
                   whose tiles split over the model group
                   (``kernels/pfedsop_update/ops.py::
                   pfedsop_update_batched_sharded``).
  ShardMapBackend  the 1-D case: the cohort over a ``clients`` mesh of
                   ``resolve_shards`` ranks (with a ``replicas`` axis over
                   the rest of the world when the shard count is smaller).

Every rank runs the whole driver on the same host numpy sampling, so each
holds the same cohort ids, batches and broadcast.  A phase on a mesh has
one fixed shape:

  1. each rank takes its client rows (the store gathers only those);
     model-sharded-at-rest leaves are all-gathered over the model group;
     with the data split (below), each per-step batch is cut to this data
     rank's chunk;
  2. the method's cohort step (pFedSOP's round start: one launch pair of
     the update kernels, collectives allowed) runs on the local rows
     under the model-shard context;
  3. one ``torch.func.vmap`` of the one-client function over the local
     clients, with no collective inside it (``launch/collectives.py``
     refuses one there: under vmap a gloo all_gather returns zeros) but
     the data split's ``gather_chunks``, a custom op with a vmap rule;
     or, in the loop form (``loop=True``: the LM train step, whose kernels
     read ``data_ptr()`` and whose remat refuses ``torch.func``), the
     local clients one after another under the model-shard context, their
     outputs stacked: the same shapes and the same collectives;
  4. ``replicate``: an ``all_gather`` over the client group in rank order
     returns every output to every rank (skipped by
     ``output_sharding="sharded"``, where ``aggregate_phase`` reduces the
     rank-local uploads in rank order instead).

The data split (``repro``'s ``_data_split``): when the run's gradient
chunk count (``data_chunks``, ``FLRunConfig.grad_chunks``) equals the
data axis's size (> 1) and every batch leaf is stacked (client, step,
batch, ...) with a batch dim the data size divides, each data rank takes
its contiguous chunk of every per-step batch and the client phase runs in
``data_shard_axis(data group, data size)``: each rank computes one
gradient chunk and gathers the n partials (``optim/sgd.py``).  Otherwise
the chunks run in the body on every data rank, with the same numbers;
``data_split`` records which layout the last client phase took.

Pure data movement around the same per-client computation, so a mesh
history is bitwise the vmap history.  That needs each client's numbers to
be independent of how many clients share its vmap: a vmapped convolution
folds its clients into one grouped convolution, whose gradient over 4
clients differs in the last bits from 2 + 2 (on the CPU, and on the card
under ``cudnn.deterministic``: 20 clients against 2 x 10).  So every
backend maps its clients one at a time (``torch.func.vmap``'s
``chunk_size=1``): bitwise
whatever the split, on the CPU and on the card, at a cost in round time
(PERF.md, §6; ``scripts/torch_client_chunk.py``).
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Optional, Union

import torch.distributed as dist
import torch.func

from repro_torch.kernels.dispatch import client_shard_axis, data_shard_axis, model_shard_axis
from repro_torch.launch import collectives
from repro_torch.launch.mesh import MeshSpec, is_auto_clients, parse_mesh, resolve_mesh
from repro_torch.launch.sharding import client_stacked_specs, leaf_plan
from repro_torch.utils.pytree import (
    tree_flatten,
    tree_leaves,
    tree_map,
    tree_stack,
    tree_unflatten,
)

CLIENT_AXIS = "clients"
REPLICA_AXIS = "replicas"
BACKENDS = ("vmap", "shard_map", "mesh")


def _run_vmap(fn, states, broadcast, rest):
    # one client a call of the vmapped function, so a client's numbers do
    # not depend on how many clients share its rank (module docstring)
    return torch.func.vmap(fn, in_dims=(0, None, 0), chunk_size=1)(states, broadcast, rest)


def client_tree(tree, i):
    """Client ``i``'s slice of a tree whose leaves lead with the client axis."""
    return tree_map(lambda x: x[i], tree)


def stack_clients(trees):
    """Stack per-client trees on a new leading axis (one client: a view)."""
    if len(trees) == 1:
        return tree_map(lambda x: x.unsqueeze(0), trees[0])
    return tree_stack(trees)


def _run_loop(fn, states, broadcast, rest):
    """The loop form of ``_run_vmap``: ``fn`` on each client in turn, the
    outputs stacked on a new leading axis."""
    n = tree_leaves(rest)[0].shape[0]
    return stack_clients([fn(client_tree(states, i), broadcast, client_tree(rest, i))
                          for i in range(n)])


def _cohort_step(cohort_step, states, broadcast):
    if cohort_step is None:
        return states, {}
    return cohort_step(states, broadcast)


class VmapBackend:
    """Single-device backend: one ``torch.func.vmap`` over the cohort."""

    name = "vmap"
    n_pods = 1
    client_sharded = False
    client_shards = 1
    # outputs are born whole: there is nothing to replicate
    replicate = None

    def signature(self) -> str:
        return "vmap"

    def client_phase(self, one_client, states, broadcast, batches,
                     cohort_step=None, shardings=None, loop=False):
        """(states, broadcast, batches) -> (new_states, uploads, metrics);
        ``cohort_step(states, broadcast) -> (states, cohort_metrics)`` runs
        first on the whole cohort (pFedSOP's round start); ``loop`` runs the
        clients one after another instead of under ``vmap``."""
        states, cohort_metrics = _cohort_step(cohort_step, states, broadcast)
        run = _run_loop if loop else _run_vmap
        new_states, uploads, metrics = run(one_client, states, broadcast, batches)
        return new_states, uploads, {**metrics, **cohort_metrics}

    client_phase_sharded = client_phase

    def eval_phase(self, one_eval, states, broadcast, test_sets):
        return _run_vmap(one_eval, states, broadcast, test_sets)

    def input_shardings(self, tree):
        """No placement: the store gathers the whole cohort."""
        return None

    def describe(self):
        return {"backend": self.name, "shards": 1}


def resolve_shards(kprime: int, n_devices: int, requested: int = 0) -> int:
    """Shard count for a K'-client round on ``n_devices`` ranks.

    The stacked-client axis is split evenly (no padding: padded dummy
    clients would change the server mean), so the shard count must divide
    K'.  ``requested=0`` picks the largest divisor of K' that fits the
    device count; an explicit request is validated strictly."""
    if requested < 0:
        raise ValueError(f"shards must be >= 0 (0 = auto), got {requested}")
    if requested:
        if requested > n_devices:
            raise ValueError(
                f"requested {requested} shards but only {n_devices} devices")
        if kprime % requested:
            raise ValueError(
                f"shards={requested} must divide the {kprime} participating "
                "clients per round (no padding)")
        return requested
    for n in range(min(kprime, n_devices), 0, -1):
        if kprime % n == 0:
            return n
    return 1


def resolve_client_split(kprime: int, spec: MeshSpec, strict: bool = True) -> bool:
    """Whether a K'-cohort can split over ``spec``'s client-role axis.

    A mesh's client-axis size is fixed by the spec, so a non-divisor K' has
    no partial split: ``strict=True`` raises (a requested layout is never
    silently changed); ``strict=False`` (the async driver's micro-cohorts)
    falls back to an unsharded client axis (the cohort replicates across
    pods; the model-sharded update still applies).  Returns True when the
    client axis is used, False for the fallback."""
    size = spec.client_size
    if spec.client_axis is None or size == 1:
        return False
    if kprime % size == 0:
        return True
    if strict:
        raise ValueError(
            f"mesh {spec.signature()}: client axis {spec.client_axis!r} of "
            f"size {size} must divide the {kprime} participating clients per "
            "round (no padding) — pick a dividing pod count or adjust "
            "participation")
    return False


@dataclass(frozen=True)
class LeafShard:
    """This rank's part of one client-stacked leaf at rest: its ``rows`` of
    the cohort and, for a model-sharded leaf, ``(dim, slice)`` of the
    model group's split."""

    rows: slice
    model: Optional[tuple] = None


class MeshBackend:
    """Mesh engine: the cohort over the client-role axis of a MeshSpec,
    over the ranks of the default process group (module docstring)."""

    name = "mesh"

    def __init__(self, kprime: int, spec: MeshSpec, strict: bool = True,
                 data_chunks: int = 0):
        self.kprime = kprime
        self.spec = spec
        self.client_sharded = resolve_client_split(kprime, spec, strict)
        self.mesh = resolve_mesh(spec)
        # FLRunConfig.grad_chunks: the data split engages when it equals the
        # data axis's size (module docstring); ``data_split`` records the
        # layout the last client phase took (None before the first)
        self.data_chunks = int(data_chunks)
        self.data_split = None

    @property
    def client_shards(self) -> int:
        return self.spec.client_size if self.client_sharded else 1

    @property
    def n_pods(self) -> int:
        """Pods the async scheduler maps micro-cohorts onto: the client-axis
        size of an explicit multi-pod mesh; 1 otherwise."""
        return (self.spec.client_size
                if self.spec.client_axis == "pod" and self.client_sharded
                else 1)

    @property
    def laid_out(self) -> bool:
        """Whether outputs are laid out over the client group: the split is
        active, or the client axis has one rank (its collectives then copy,
        and the sharded round loop runs as at any power-of-two split)."""
        return self.spec.client_axis is not None and (
            self.client_sharded or self.spec.client_size == 1)

    def signature(self) -> str:
        sig = self.spec.signature()
        if not self.client_sharded:
            sig += "|cohort-replicated"
        if self.data_chunks > 1:
            sig += f"|data-chunks={self.data_chunks}"
        return sig

    # -- groups and slices ---------------------------------------------

    def _group(self, axis: str):
        return self.mesh.get_group(axis)

    def _local_rank(self, axis: str) -> int:
        return self.mesh.get_local_rank(axis)

    def _rows(self) -> slice:
        """This rank's rows of the K'-cohort."""
        if not self.client_sharded:
            return slice(0, self.kprime)
        k = self.kprime // self.spec.client_size
        r = self._local_rank(self.spec.client_axis)
        return slice(r * k, (r + 1) * k)

    def _local_rows(self, tree):
        """Leaves with the whole cohort's rows cut to this rank's; leaves
        already local pass as they are."""
        rows = self._rows()
        local = rows.stop - rows.start

        def cut(x):
            if x.shape[0] == self.kprime:
                return x[rows]
            if x.shape[0] != local:
                raise ValueError(f"leaf of {x.shape[0]} rows: neither the cohort's "
                                 f"{self.kprime} nor this rank's {local}")
            return x

        return tree_map(cut, tree)

    def _model_context(self):
        msize = self.spec.model_size
        if self.spec.model_axis is None or msize <= 1:
            return contextlib.nullcontext()
        return model_shard_axis(self._group(self.spec.model_axis), msize)

    def _data_split(self, batches) -> bool:
        """Whether this call's batch tree splits over the data axis: the
        chunk count equals the data size (> 1), so this rank's slice IS one
        chunk, and every leaf is stacked (client, step, batch, ...) with a
        batch dim (index 2) the data size divides.  Otherwise the chunks
        run in the body, with the same numbers."""
        dsize = self.spec.data_size
        if self.spec.data_axis is None or dsize <= 1 or self.data_chunks != dsize:
            return False
        leaves = tree_leaves(batches)
        return bool(leaves) and all(x.dim() >= 3 and x.shape[2] % dsize == 0 for x in leaves)

    def _data_chunk(self, batches):
        """This data rank's contiguous chunk of every per-step batch."""
        dsize = self.spec.data_size
        r = self._local_rank(self.spec.data_axis)
        return tree_map(lambda x: x.narrow(2, r * (x.shape[2] // dsize), x.shape[2] // dsize),
                        batches)

    def input_shardings(self, tree, seqshard: bool = False):
        """Per-leaf ``LeafShard`` of a client-stacked cohort tree (only the
        shapes are read): this rank's rows, and its model slice of the
        leaves the param rules shard (``launch/sharding.py::
        client_stacked_specs``; ``seqshard``: of ``embed`` / ``heads``
        only).  The host stores gather against these."""
        caxis = self.spec.client_axis if self.client_sharded else None
        maxis, msize = self.spec.model_axis, self.spec.model_size
        specs = client_stacked_specs(tree, caxis, model_axis=maxis, msize=msize,
                                     seqshard=seqshard)
        rows = self._rows()
        sizes = {maxis: msize} if maxis is not None else {}
        ranks = {maxis: self._local_rank(maxis)} if msize > 1 else {}
        leaves, treedef = tree_flatten(tree)
        out = []
        for x, spec in zip(leaves, specs):
            cuts = leaf_plan(spec, x.shape, sizes, ranks).cuts
            out.append(LeafShard(rows, cuts[0] if cuts else None))
        return tree_unflatten(treedef, out)

    def _gather_model(self, tree, shardings):
        """Model-sharded leaves all-gathered over the model group (in rank
        order) so the per-client compute sees whole leaves; storage stays
        sharded."""
        if self.spec.model_axis is None or self.spec.model_size <= 1:
            return tree
        group = self._group(self.spec.model_axis)
        return tree_map(
            lambda x, sh: x if sh.model is None
            else collectives.all_gather(x, group, dim=sh.model[0]),
            tree, shardings)

    # -- phases ------------------------------------------------------------

    def client_phase_sharded(self, one_client, states, broadcast, batches,
                             cohort_step=None, shardings=None, loop=False):
        """The client phase WITHOUT the closing all-gather: outputs hold
        this rank's rows.  ``states`` are at rest as ``shardings`` lays
        them out (the store's gather), or the whole cohort when None;
        ``loop`` runs the local clients one after another (the module
        docstring's step 3)."""
        if shardings is None:
            states = self._local_rows(states)
        else:
            states = self._gather_model(states, shardings)
        batches = self._local_rows(batches)
        self.data_split = self._data_split(batches)
        with contextlib.ExitStack() as ctx:
            if self.data_split:
                batches = self._data_chunk(batches)
                ctx.enter_context(data_shard_axis(self._group(self.spec.data_axis),
                                                  self.spec.data_size))
            with self._model_context():
                states, cohort_metrics = _cohort_step(cohort_step, states, broadcast)
                if loop:
                    out = _run_loop(one_client, states, broadcast, batches)
            if not loop:
                out = _run_vmap(one_client, states, broadcast, batches)
        new_states, uploads, metrics = out
        return new_states, uploads, {**metrics, **cohort_metrics}

    def client_phase(self, one_client, states, broadcast, batches,
                     cohort_step=None, shardings=None, loop=False):
        return self.replicate(self.client_phase_sharded(
            one_client, states, broadcast, batches, cohort_step, shardings, loop))

    def replicate(self, out):
        """The round-boundary all-gather: every rank's rows of every leaf,
        in rank order, to every rank.  Pure data movement: the values are
        the ones the sharded phase computed."""
        if not self.laid_out:
            return out
        group = self._group(self.spec.client_axis)
        return tree_map(lambda x: collectives.all_gather(x, group), out)

    def aggregate_phase(self, fn, broadcast, *upload_trees):
        """Server aggregation over the rank-local uploads: ``fn`` (the
        method's ``server_update``) runs under ``client_shard_axis``, so its
        cohort reductions combine rank-local halving-tree partials in rank
        order (``optim/reduce.py``), bitwise the whole-cohort result at a
        power-of-two split.  Every rank gets the same new broadcast."""
        with client_shard_axis(self._group(self.spec.client_axis), self.spec.client_size):
            return fn(broadcast, *upload_trees)

    def eval_phase(self, one_eval, states, broadcast, test_sets):
        """Per-client accuracies (K',) on every rank; ``states`` are the
        whole cohort or this rank's rows."""
        accs = _run_vmap(one_eval, self._local_rows(states), broadcast,
                         self._local_rows(test_sets))
        return self.replicate(accs)

    def describe(self):
        out = {
            "backend": self.name,
            "mesh": self.spec.signature(),
            "shards": self.client_shards,
            "n_pods": self.n_pods,
            "model_shards": self.spec.model_size,
            "ranks": self.spec.n_devices,
        }
        if self.data_chunks > 1:
            out["data_chunks"] = self.data_chunks
        return out


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _clients_spec(shards: int, world: int) -> MeshSpec:
    """The 1-D client mesh of ``shards`` ranks, with a ``replicas`` axis
    over the rest of a larger world (each replica computes the same)."""
    if shards == world:
        return MeshSpec.clients(shards, CLIENT_AXIS)
    return MeshSpec((shards, world // shards), (CLIENT_AXIS, REPLICA_AXIS),
                    client_axis=CLIENT_AXIS)


class ShardMapBackend(MeshBackend):
    """1-D special case of ``MeshBackend``: the participating-client axis
    over a ``clients`` mesh; shard count from (K', world size) by
    ``resolve_shards``.  Every rank of the world takes part, so the shard
    count must divide the world size too: an explicit one that does not
    raises, an automatic one steps down to the largest common divisor."""

    name = "shard_map"

    def __init__(self, kprime: int, shards: int = 0, data_chunks: int = 0):
        world = _world()
        n = resolve_shards(kprime, world, shards)
        if world % n:
            if shards:
                raise ValueError(f"shards={shards} must divide the {world} ranks "
                                 "(every rank takes part in the client mesh)")
            n = math.gcd(n, world)
        self.shards = n
        super().__init__(kprime, _clients_spec(n, world), data_chunks=data_chunks)

    def describe(self):
        return {"backend": self.name, "shards": self.shards,
                "ranks": self.spec.n_devices}


def make_engine(backend: str, kprime: int, shards: int = 0,
                mesh: Union[str, MeshSpec, None] = None,
                strict: bool = True, data_chunks: int = 0):
    """Engine factory used by ``Federation`` (selected via FLRunConfig).

    ``mesh`` (a spec string for ``launch.mesh.parse_mesh``, or a
    ``MeshSpec``) selects the layout for ``backend="mesh"`` and is refused
    elsewhere; like ``shards``, a layout request is never silently
    ignored.  ``strict=False`` (the async driver's micro-cohorts) lets a
    non-divisor cohort fall back instead of erroring.  ``data_chunks`` is
    ``FLRunConfig.grad_chunks``: the mesh engines' data split engages when
    it equals the data axis's size (the vmap backend computes its chunks in
    the body, so it takes no engine knob)."""
    if backend == "vmap":
        if shards or mesh:
            raise ValueError(
                "shards/mesh are only meaningful with backend='shard_map'/"
                f"'mesh' (got shards={shards}, mesh={mesh!r} with "
                "backend='vmap')")
        return VmapBackend()
    if backend == "shard_map":
        if mesh:
            raise ValueError(
                "backend='shard_map' is the 1-D client mesh; pass the mesh "
                f"spec (got {mesh!r}) with backend='mesh' instead")
        # async micro-cohorts (strict=False): a requested split that does not
        # divide the cohort falls back to auto (largest divisor)
        if not strict and shards and kprime % shards:
            shards = 0
        return ShardMapBackend(kprime, shards, data_chunks=data_chunks)
    if backend == "mesh":
        if shards:
            raise ValueError(
                "backend='mesh' takes its client split from the mesh spec's "
                f"client-role axis; shards={shards} is only meaningful with "
                "backend='shard_map'")
        if not mesh:
            raise ValueError(
                "backend='mesh' requires a mesh spec (FLRunConfig.mesh / "
                "--mesh), e.g. 'pods:2x1x2'; see repro_torch.launch.mesh.parse_mesh")
        spec = parse_mesh(mesh) if isinstance(mesh, str) else mesh
        if is_auto_clients(spec):
            spec = _clients_spec(math.gcd(resolve_shards(kprime, _world()), _world()),
                                 _world())
        return MeshBackend(kprime, spec, strict=strict, data_chunks=data_chunks)
    raise ValueError(f"unknown FL backend {backend!r}; choose from {BACKENDS}")
