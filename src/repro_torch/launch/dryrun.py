"""Dry run: count a whole step on the meta device, at one device or as
rank 0 of the production meshes.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b --shape train_4k \
        --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

Port of ``repro/launch/dryrun.py``.  ``repro`` lowers the step with
``ShapeDtypeStruct`` stand-ins and reads XLA's analyses; the port runs the
real step once on meta tensors (``steps.input_specs``), which have shapes,
dtypes and storage sizes and no data, so nothing is allocated and every op
of the step is seen.  The kernels take their meta path
(``repro_torch.kernels.meta``): the CUDA path's outputs and scratch, and a
record of each launch with its cost.

``--mesh`` (``run_one``'s ``mesh``):

  one     one device (the default; what ``launch/calibrate.py`` and
          ``chip_smoke.py`` phase 15 read): records ``<arch>__<shape>__1.json``;
  single  ``repro``'s 16x16 single-pod mesh, ``MeshSpec.single_pod(16, 16)``:
          256 ranks, one client; ``__16x16.json``;
  multi   ``repro``'s 2x16x16 multi-pod mesh, ``MeshSpec.multi_pod(2, 16, 16)``:
          512 ranks, 2 clients (one a pod); ``__2x16x16.json``;
  both    single, then multi.

On a mesh the count runs rank 0's program inside a one-process
``torch.distributed`` group of the mesh's world size on the ``fake``
backend (``torch.testing._internal.distributed.fake_pg``: collectives
complete without moving data), through a ``MeshBackend`` with
``data_chunks = 16`` as ``repro``'s does.  A train step runs
``make_train_step(engine=)``: rank 0's client state at rest is its rows
with the Megatron-eligible leaves cut to its model slice
(``launch/sharding.py``'s rules, ``MeshBackend.input_shardings``) and the
engine gathers them; its per-step batch is its data rank's chunk (2 of
the micro batch's 32 sequences), whose gradient it gathers with the 15
others' (``optim/sgd.py``'s data split); the round start runs K1/K2 on
its tile range; multi-pod, Eq. 13 gathers the two pods' partial sums.
The global delta is whole on every rank.  The train records stay on
this engine lowering, as ``repro``'s dry run lowers its train step
through ``MeshBackend``: every rank of a model group computes the same
chunk.  (The tensor-parallel train step, ``make_train_step(tp=)``, is
``launch/train.py``'s replicated step on a model axis; ``chip_smoke.py``
phase 19 counts it with ``count`` in a 2-rank ``fake_world``.  The
sequence-parallel ``seqshard`` is ROADMAP.md queue 1, item 16b.)  A prefill or
decode step on a mesh, of every arch, is rank 0's tensor-parallel program
(``launch/steps.py``'s ``tp``, ``models/parallel.py``): its model slice
of every leaf ``launch/sharding.py``'s rules split (attention, MLP,
experts, the SSM's projections and conv, the vocab tables and heads),
its data rank's rows of the batch and its slice of every cache (batch
rows over ``data``; KV slots, int8 scales included, SSM conv channels
and state heads over ``model``), cut by ``launch/sharding.py::rank_plan``
from rank 0's pod's client, with the collectives that layout needs; the
record says ``"serve_layout": "tensor_parallel"``.
Per (arch x shape x mesh) the record under ``experiments/dryrun_torch/``
has ``repro``'s keys:

  memory_analysis  argument bytes (the inputs' storages), output bytes (the
                   result's new storages) and temp bytes (the peak of the
                   live meta storages minus the arguments), per rank: the
                   step's peak device memory is argument + temp;
  cost_analysis    flops (``torch.utils.flop_counter.FlopCounterMode`` plus
                   the kernels' counted FLOPs) and bytes accessed (every
                   op's operand and result bytes, the unfused eager traffic
                   the card pays, plus the kernels' counted bytes), per rank;
  collectives      ``launch/collectives.py``'s census of rank 0's calls,
                   ``{op: {bytes, count}}`` with each op's result bytes;
  roofline         ``roofline.roofline_terms`` on the H100's rates, with
                   ``n_devices`` 1, 256 or 512;

and the port's own ``launches`` (per kernel), ``kernels`` (their FLOPs and
bytes), ``peak_bytes`` and ``fits`` (the peak against the card's 80 GB).
``moe_dispatch`` / ``moe_grouped`` run the capacity-based MoE dispatch,
whose shapes are static (set by the capacity, not the routing);
``seqshard`` is refused (ROADMAP.md queue 1, item 16b).

The live-bytes tracker (``MemoryCounter``) follows each storage an op
returns until its last reference goes: the peak it reads is the caching
allocator's ``max_memory_allocated`` on the card, less the allocator's
rounding (512 bytes a block), the cuBLAS workspace and the scratch of ATen
kernels that the dispatcher does not see.  The largest such scratch on the
train path is ``logsumexp``'s, which ATen's kernel computes as
``sum(exp(x - max))`` into a temporary of its input's size (the f32 logits
of the cross-entropy); ``SCRATCH`` adds it.  The reverse: ``gather``'s
backward scatters the gradient into fresh zeros in place, but under any
dispatch mode (this tracker's included) autograd takes its out-of-place
branch, whose result is a second buffer of the zeros' size that the card
never holds (the f32 logits of the cross-entropy again); the tracker
leaves that twin out of the peak.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import time
import traceback
import weakref
from pathlib import Path

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_NAMES, INPUT_SHAPES, get_config
from repro_torch.configs.base import InputShape
from repro_torch.fl.engine import MeshBackend, client_tree, stack_clients
from repro_torch.kernels import meta
from repro_torch.launch import collectives
from repro_torch.launch import steps as st
from repro_torch.launch.mesh import MeshSpec
from repro_torch.launch.roofline import HBM_CAPACITY, roofline_terms
from repro_torch.launch.sharding import rank_plan
from repro_torch.utils.pytree import tree_leaves, tree_map
from repro_torch.weights import cut

ART_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
VARIANTS = {"baseline": None, "moe_dispatch": "dispatch", "moe_grouped": "dispatch_grouped"}
# --mesh name -> (its MeshSpec, None for one device; the records' mesh tag)
MESHES = {"one": (None, "1"), "single": (MeshSpec.single_pod(16, 16), "16x16"),
          "multi": (MeshSpec.multi_pod(2, 16, 16), "2x16x16")}

aten = torch.ops.aten
# ops that allocate or alias without moving data
_NO_TRAFFIC = {aten.empty.memory_format, aten.empty_strided.default, aten.empty_like.default,
               aten.new_empty.default, aten.new_empty_strided.default,
               aten._unsafe_view.default, aten.lift_fresh.default}
# scratch an ATen kernel allocates inside one op, in bytes, from its inputs
SCRATCH = {aten.logsumexp.default: lambda x, *_: x.numel() * x.element_size()}


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None and not r.alias_info.is_write
                              for r in rets)


class MemoryCounter(TorchDispatchMode):
    """Live bytes of the storages that ops return, from each op until its
    storage's last reference goes (a finalizer on the storage), and the bytes
    every op reads and writes.

    ``held``: tensors alive before the count starts (the step's arguments);
    their storages count as live throughout.  ``peak`` is the most bytes
    live at once, ``traffic`` the sum over ops of operand and result bytes
    (views, allocations and aliases move nothing)."""

    def __init__(self, held=()):
        super().__init__()
        self._live = {}  # storage key -> bytes
        for t in _tensors(held):
            s = t.untyped_storage()
            self._live[s._cdata] = s.nbytes()
        self._held = set(self._live)
        self.held = self.live = self.peak = sum(self._live.values())
        self.traffic = 0
        self.ops = 0
        self._zeros = None  # the storage the last op filled with zeros, if new_zeros

    def _free(self, key, n):
        if self._live.pop(key, None) is not None:
            self.live -= n

    def _track(self, t):
        s = t.untyped_storage()
        key = s._cdata
        if key not in self._live:
            n = self._live[key] = s.nbytes()
            self.live += n
            weakref.finalize(s, self._free, key, n)

    def storage_bytes(self, tree) -> int:
        """Bytes of the distinct storages under ``tree`` not held at the start."""
        seen = {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
                for t in _tensors(tree)}
        return sum(n for k, n in seen.items() if k not in self._held)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        for t in outs:
            self._track(t)
        scratch = SCRATCH[func](*args, **kwargs) if func in SCRATCH else 0
        twin = 0  # gather's backward out of place (the module docstring)
        if func is aten.scatter_add.default and args[0].untyped_storage()._cdata == self._zeros:
            twin = outs[0].untyped_storage().nbytes()
        self._zeros = outs[0].untyped_storage()._cdata if func is aten.new_zeros.default else None
        self.peak = max(self.peak, self.live + scratch - twin)
        self.ops += 1
        if func not in _NO_TRAFFIC and not _is_view(func):
            self.traffic += sum(t.numel() * t.element_size()
                                for t in _tensors((args, kwargs)) + outs)
        return out


def count(step, args):
    """Run ``step(*args)`` once on meta tensors and count it: returns (the
    result, {"flops", "bytes", "launches", "kernels", "argument", "output",
    "temp", "peak", "ops"})."""
    with FlopCounterMode(display=False) as flops, meta.census() as census, \
            MemoryCounter(args) as mem:
        out = step(*args)
    return out, {
        "flops": flops.get_total_flops() + sum(census.flops.values()),
        "bytes": mem.traffic + sum(census.bytes.values()),
        "launches": dict(census.launches),
        "kernels": {k: {"launches": n, "flops": census.flops[k], "bytes": census.bytes[k]}
                    for k, n in census.launches.items()},
        "argument": mem.held, "output": mem.storage_bytes(out),
        "temp": mem.peak - mem.held, "peak": mem.peak, "ops": mem.ops,
    }


def _per_client(step, client_args):
    """A serving step (one client's trees) over the leading client axis of
    the arguments at the positions ``client_args``."""
    def run(*args):
        n = tree_leaves(args[0])[0].shape[0]
        return stack_clients([
            step(*(client_tree(a, i) if j in client_args else a for j, a in enumerate(args)))
            for i in range(n)])
    return run


def resolve_shape(shape) -> InputShape:
    return INPUT_SHAPES[shape] if isinstance(shape, str) else shape


def micro_batch_for(cfg, micro_batch: int) -> int:
    """The train micro batch: the arch's own when the default is asked for."""
    return min(micro_batch, cfg.train_micro_batch) if micro_batch == st.MICRO_BATCH else micro_batch


def _at_rest(tree, shardings):
    """New meta leaves of this rank's part of a client-stacked tree at rest:
    its rows and, for a model-sharded leaf, its model slice."""
    def cut(x, sh):
        shape = list(x.shape)
        shape[0] = sh.rows.stop - sh.rows.start
        if sh.model is not None:
            d, cols = sh.model
            shape[d] = cols.stop - cols.start
        return torch.empty(shape, dtype=x.dtype, device=x.device)

    return tree_map(cut, tree, shardings)


def build_inputs(arch: str, shape, micro_batch: int = st.MICRO_BATCH,
                 variant: str = "baseline", t_override=None, cfg=None, n_clients: int = 1,
                 engine=None):
    """The step and its meta inputs for one (arch, shape): (step, args, meta).
    With a mesh ``engine`` (inside its process group), rank 0's step and
    its inputs at rest, one client a pod (the module docstring)."""
    cfg = cfg or get_config(arch)
    if variant == "seqshard":
        raise NotImplementedError(
            "variant 'seqshard' shards the sequence over the model group, a "
            "sequence-parallel forward the port does not have; see ROADMAP.md "
            "queue 1, item 16b (seqshard)")
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; choose from {tuple(VARIANTS)}")
    if VARIANTS[variant]:
        cfg = cfg.replace(moe_impl=VARIANTS[variant])
    shape = resolve_shape(shape)
    micro_batch = micro_batch_for(cfg, micro_batch)
    if engine is not None:
        n_clients = engine.kprime
    specs = st.input_specs(cfg, shape, n_clients=n_clients, micro_batch=micro_batch,
                           t_override=t_override)
    rcfg = st.resolve_cfg(cfg, shape)
    if shape.kind == "train":
        step = st.make_train_step(cfg, shape, engine=engine)
        state = specs["state"]
        if engine is not None:
            shardings = {k: engine.input_shardings(v) for k, v in state.items()}
            state = {k: _at_rest(v, shardings[k]) for k, v in state.items()}
            step = functools.partial(step, shardings=shardings)
        args = (state, specs["global_delta"], specs["batches"])
    else:
        tp = st.tensor_parallel(engine.spec, engine.mesh) if engine is not None else None
        if shape.kind == "prefill":
            client_args = {0: "params", 1: "batch"}
            step = _per_client(st.make_prefill_step(cfg, shape, tp=tp), client_args)
            args = (specs["params"], specs["batch"])
        else:
            client_args = {0: "params", 1: "batch", 3: "caches"}
            step = _per_client(st.make_serve_step(cfg, shape, tp=tp), client_args)
            args = (specs["params"], specs["batch"], specs["pos"], specs["caches"])
        if engine is not None:  # rank 0's pod's rows, each leaf its own storage
            rows = engine._rows()
            args = tuple(_rank_part(tree_map(lambda x: x[rows], a), client_args[j], tp)
                         if j in client_args else a for j, a in enumerate(args))
    spec = engine.spec if engine is not None else None
    info = {
        "arch": arch, "shape": shape.name, "mesh": "1", "variant": variant,
        "n_devices": spec.n_devices if spec else 1, "kind": shape.kind,
        "micro_batch": micro_batch if shape.kind == "train" else None,
        "long_context_mode": rcfg.long_context_mode if shape.name == "long_500k" else None,
        "cfg_name": rcfg.name,
    }
    if engine is not None and shape.kind != "train":
        info["serve_layout"] = "tensor_parallel"
    return step, args, info


def _rank_part(tree, kind, tp):
    """This rank's part of a client-stacked serving input, cut by the
    rank's plan, each leaf its own storage."""
    plan = rank_plan(tree, kind, tp.data_size, tp.size, tp.data_rank, tp.rank, client=True)
    return cut(tree, plan)


@contextlib.contextmanager
def fake_world(n: int):
    """A one-process ``torch.distributed`` group of ``n`` ranks on the
    ``fake`` backend, this process rank 0; destroyed on exit.  Refuses to
    start inside another group."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run's mesh count starts its own fake process group of "
                           "the mesh's world size; a group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def run_one(arch: str, shape, save: bool = True, verbose: bool = True,
            variant: str = "baseline", micro_batch: int = st.MICRO_BATCH,
            mesh: str = "one", cfg=None, t_override=None):
    """Count one (arch, shape) step on the meta device; returns the record.

    ``shape``: a name of ``INPUT_SHAPES`` or an ``InputShape``; ``mesh``: a
    key of ``MESHES`` (the module docstring) or a ``MeshSpec`` (tagged by
    its shape, e.g. ``2x2x2``); ``cfg`` replaces ``get_config(arch)`` (the
    calibration's unrolled configs)."""
    if isinstance(mesh, MeshSpec):
        spec, tag = mesh, "x".join(map(str, mesh.shape))
    elif mesh in MESHES:
        spec, tag = MESHES[mesh]
    else:
        raise ValueError(f"mesh {mesh!r}: choose from {tuple(MESHES)} ('both' is the "
                         "CLI's single + multi) or pass a MeshSpec")
    t0 = time.time()
    with fake_world(spec.n_devices) if spec else contextlib.nullcontext():
        engine = None
        if spec is not None:
            engine = MeshBackend(spec.client_size if spec.client_axis else 1, spec,
                                 strict=False, data_chunks=spec.data_size)
        step, args, record = build_inputs(arch, shape, micro_batch, variant, t_override, cfg,
                                          engine=engine)
        collectives.reset_census()
        _, c = count(step, args)
        census = collectives.census() if spec else {}
        if engine is not None and record["kind"] == "train":
            record["data_split"] = engine.data_split
    record["mesh"] = tag
    record["count_s"] = round(time.time() - t0, 2)
    record["memory_analysis"] = {"argument_size_in_bytes": c["argument"],
                                 "output_size_in_bytes": c["output"],
                                 "temp_size_in_bytes": c["temp"]}
    record["cost_analysis"] = {"flops": float(c["flops"]), "bytes accessed": float(c["bytes"])}
    record["collectives"] = census
    record["launches"] = c["launches"]
    record["kernels"] = c["kernels"]
    record["ops"] = c["ops"]
    record["peak_bytes"] = c["peak"]
    record["fits"] = c["peak"] <= HBM_CAPACITY
    record["roofline"] = roofline_terms(record, n_devices=record["n_devices"])

    if verbose:
        print(f"== {arch} x {record['shape']} [{tag}] ({variant}) ==")
        print(f"   counted {c['ops']} ops in {record['count_s']:.1f}s")
        print(f"   memory_analysis: {record['memory_analysis']}; peak "
              f"{c['peak'] / 2**30:.3f} GiB, fits={record['fits']}")
        print(f"   cost: flops={record['cost_analysis']['flops']:.6g} "
              f"bytes={record['cost_analysis']['bytes accessed']:.6g}")
        print(f"   launches: {record['launches']}")
        print("   collectives: " + (", ".join(
            f"{k}={v['bytes']:.3e}B x{v['count']}" for k, v in census.items()) or "none"))
        print(f"   roofline: {record['roofline']}")
    if save:
        ART_DIR.mkdir(parents=True, exist_ok=True)
        name = f"{arch}__{record['shape']}__{tag}"
        if variant != "baseline":
            name += f"__{variant}"
        (ART_DIR / f"{name}.json").write_text(json.dumps(record, indent=1))
    return record


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=list(ARCH_NAMES), default=None)
    ap.add_argument("--shape", choices=list(INPUT_SHAPES), default=None)
    ap.add_argument("--mesh", choices=[*MESHES, "both"], default="one")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--micro-batch", type=int, default=st.MICRO_BATCH)
    args = ap.parse_args(argv)

    archs = list(ARCH_NAMES) if (args.all or args.arch is None) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = ("single", "multi") if args.mesh == "both" else (args.mesh,)
    failures = []
    for arch in archs:
        for shape in shapes:
            for mesh in meshes:
                try:
                    run_one(arch, shape, variant=args.variant, micro_batch=args.micro_batch,
                            mesh=mesh)
                except NotImplementedError:
                    raise
                except Exception as e:  # noqa: BLE001 - report, keep sweeping
                    failures.append((arch, shape, mesh, repr(e)))
                    print(f"!! FAIL {arch} x {shape} [{mesh}]: {e}")
                    traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print("\nALL DRY-RUNS PASSED")


if __name__ == "__main__":
    main()
