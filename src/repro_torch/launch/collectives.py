"""The port's collectives over ``torch.distributed``, with their census.

The only module of the port that calls ``torch.distributed``'s
collectives; the federation engines, the ordered cohort reductions and
the model-sharded update reach the other ranks through these functions:

  ``all_gather``   every rank's tensor, concatenated along ``dim`` in the
                   group's rank order (the order the halving trees of
                   ``optim/reduce.py`` rely on);
  ``gather_chunks`` every rank's tensor stacked on a new leading axis in
                   rank order (JAX's non-tiled ``all_gather(..., axis=0)``):
                   the data split's gradient chunks (``optim/sgd.py``);
  ``all_reduce``   an in-place SUM;
  ``reduce_scatter`` every rank's tensor summed, this rank's share of the
                   sum along ``dim`` in rank order (the sequence-parallel
                   prefill's embedding): NCCL's reduce-scatter; gloo has
                   none, so there (and on the dry run's ``fake`` backend)
                   an all-reduce, then the slice;
  ``broadcast``    from a group rank;
  ``barrier``.

Each call adds to ``CENSUS`` in ``repro``'s collective schema
(``launch/roofline.py::collective_bytes_from_hlo``, which the port has no
HLO to parse for): ``{op: {"bytes", "count"}}`` with the op named as HLO
names it ("all-gather", "all-reduce", "reduce-scatter",
"collective-broadcast") and the bytes of the op's RESULT on this rank (a
reduce-scatter is counted as one whatever the backend runs for it, so the
dry run's count and a gloo run's census agree); ``launch/roofline.py::
roofline_terms`` reads the same schema.  A barrier moves no data and is
counted under "barrier" with 0 bytes.  The sequence-parallel prefill's
three small gathers are counted apart, under the names
``models/parallel.py`` gives them ("all-gather:conv-halo",
"all-gather:ssm-state", "all-gather:moe-counts"), so a census shows what
each costs; the roofline sums every entry alike.

A collective refuses to run under a ``torch.func`` transform (``vmap``,
``grad``): a gloo ``all_gather`` of a vmapped tensor returned zeros with
no error but a ``wait_tensor`` warning (torch 2.13, world 2), so a
collective inside the engine's vmap would corrupt a history silently.
The engines run every collective outside their ``vmap``, except
``gather_chunks``: it is a ``torch.library`` custom op whose vmap rule
gathers the physical batched tensor once, vmap dim first, so the
collective itself never sees a transform's wrapper.  Its fake kernel
gives the dry run's meta path (and counts the gather there, as the card
would).

``init_world`` joins the process group a launcher (``torchrun``) set up,
or starts a one-rank group in-process; the device picks the backend,
NCCL for CUDA and gloo for the CPU, with no fallback between them.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

CENSUS: dict = {}
TIMEOUT = datetime.timedelta(seconds=120)


def reset_census() -> None:
    CENSUS.clear()


def census() -> dict:
    """A copy of the census: {op: {"bytes", "count"}}."""
    return {op: dict(v) for op, v in CENSUS.items()}


def _count(op: str, nbytes: int) -> None:
    d = CENSUS.setdefault(op, {"bytes": 0, "count": 0})
    d["bytes"] += int(nbytes)
    d["count"] += 1


def _refuse_transforms(*tensors) -> None:
    wrapped = any(torch._C._functorch.is_functorch_wrapped_tensor(t) for t in tensors)
    if wrapped or torch._C._functorch.maybe_current_level() is not None:
        raise RuntimeError(
            "a torch.distributed collective was called under a torch.func "
            "transform (vmap/grad): under vmap a gloo all_gather returns zeros "
            "with no error, so collectives run outside the engine's vmap")


def _global(group_rank: int, group) -> int:
    return group_rank if group is None else dist.get_global_rank(group, group_rank)


def rank(group=None) -> int:
    return dist.get_rank(group)


def all_gather(x: torch.Tensor, group=None, dim: int = 0, name: str = "all-gather"
               ) -> torch.Tensor:
    """Every rank's ``x`` (same shape on each rank) concatenated along
    ``dim`` in the group's rank order; counted under ``name`` (the module
    docstring)."""
    _refuse_transforms(x)
    flag = x.dtype == torch.bool  # moved as bytes: not every backend takes bool
    x = (x.to(torch.uint8) if flag else x).contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    out = torch.cat(parts, dim=dim)
    _count(name, out.nbytes)
    return out.bool() if flag else out


# the groups gather_chunks was called with, by name: a custom op's arguments
# are tensors and plain values, not process groups
_GATHER_GROUPS: dict = {}


def gather_chunks(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` stacked on a new leading axis in the group's rank
    order: ``(n, *x.shape)``.  Legal under ``torch.func.vmap`` (see the
    module docstring); counted as an "all-gather" of its result bytes."""
    group = group if group is not None else dist.group.WORLD
    _GATHER_GROUPS[group.group_name] = group
    return _gather_chunks_op(x, group.group_name)


@torch.library.custom_op("repro_torch::gather_chunks", mutates_args=())
def _gather_chunks_op(x: torch.Tensor, group_name: str) -> torch.Tensor:
    group = _GATHER_GROUPS[group_name]
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    out = torch.stack(parts)
    _count("all-gather", out.nbytes)
    return out


@_gather_chunks_op.register_fake
def _(x, group_name):
    out = x.new_empty((dist.get_world_size(_GATHER_GROUPS[group_name]),) + tuple(x.shape))
    if x.is_meta:  # the dry run: counted as the card's gather would be
        _count("all-gather", out.nbytes)
    return out


@_gather_chunks_op.register_vmap
def _(info, in_dims, x, group_name):
    if in_dims[0] is None:
        return _gather_chunks_op(x, group_name), None
    # the physical tensor, vmap dim first: one gather of every mapped slice,
    # whose result holds the vmap dim at 1
    return _gather_chunks_op(x.movedim(in_dims[0], 0), group_name), 1


def all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """In-place SUM of ``x`` over the group; returns ``x``."""
    _refuse_transforms(x)
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    _count("all-reduce", x.nbytes)
    return x


def reduce_scatter(x: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` (same shape on each rank) summed, and this rank's
    contiguous share of the sum along ``dim`` (``dim`` divides by the group
    size; rank r holds the r-th share)."""
    _refuse_transforms(x)
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} does not divide "
                         f"over {n} ranks")
    w = x.shape[dim] // n
    if dist.get_backend(group) == "nccl":
        whole = x.movedim(dim, 0).contiguous()
        out = whole.new_empty((w,) + tuple(whole.shape[1:]))
        dist.reduce_scatter_tensor(out, whole, op=dist.ReduceOp.SUM, group=group)
        out = out.movedim(0, dim).contiguous()
    else:
        whole = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(whole, op=dist.ReduceOp.SUM, group=group)
        out = whole.narrow(dim, r * w, w).contiguous()
    _count("reduce-scatter", out.nbytes)
    return out


def broadcast(x: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """In-place broadcast of ``x`` from group rank ``src``; returns ``x``."""
    _refuse_transforms(x)
    dist.broadcast(x, src=_global(src, group), group=group)
    _count("collective-broadcast", x.nbytes)
    return x


def broadcast_object(obj, src: int = 0, group=None):
    """A picklable object from group rank ``src`` (a path, a seed)."""
    box = [obj]
    dist.broadcast_object_list(box, src=_global(src, group), group=group)
    _count("collective-broadcast", 0)
    return box[0]


def barrier(group=None) -> None:
    dist.barrier(group=group)
    _count("barrier", 0)


def world_size() -> int:
    """The default group's size (1 with no group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def world_rank() -> int:
    """This process's rank in the default group (0 with no group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def init_world(device, store_path: Optional[str] = None) -> int:
    """Join the default process group; returns this process's rank.

    Under ``torchrun`` (``RANK``/``WORLD_SIZE``/``MASTER_ADDR`` in the
    environment) it joins the launched group, binding ``cuda:LOCAL_RANK``
    on the card.  Otherwise it starts a one-rank group in-process: on a
    ``FileStore`` at ``store_path`` when given, else an in-process
    ``HashStore``.  The backend follows the device: NCCL for CUDA, gloo
    for the CPU.  A group already initialized is kept as it is."""
    device = torch.device(device)
    if dist.is_initialized():
        return dist.get_rank()
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend, timeout=TIMEOUT)
    else:
        if device.type == "cuda":
            torch.cuda.set_device(device.index or 0)
        store = (dist.FileStore(store_path, 1) if store_path else dist.HashStore())
        dist.init_process_group(backend, store=store, rank=0, world_size=1,
                                timeout=TIMEOUT)
    return dist.get_rank()
