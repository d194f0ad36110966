"""Mesh layer: role-named mesh specs and their process groups.

Port of ``repro/launch/mesh.py``.  ``MeshSpec``, ``parse_mesh`` and the
auto-clients marker are copies of ``repro``'s, framework-free:

  ``MeshSpec``      axis names and sizes plus the roles they play: the
                    client axis (the participating-client cohort the
                    federation engines split), the data axis and the model
                    axis (the model-sharded round-start update).
  ``parse_mesh``    the CLI grammar ("clients[:N]" | "host" | "pod:DxM" |
                    "pods:PxDxM") -> MeshSpec, for ``--mesh``.

``resolve_mesh`` is the only function that touches ``torch.distributed``
state: it lays the spec over the ranks of the initialized default process
group as a ``DeviceMesh`` (``init_device_mesh``; NCCL on the card, gloo on
the CPU), one rank per device, and refuses a world size that is not the
spec's device count.  Each axis of the mesh is a process group
(``mesh.get_group(axis)``); the ranks of one group differ only in that
axis's coordinate, in axis order, which is the rank order every
collective of ``launch/collectives.py`` keeps.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class MeshSpec:
    """Axis names/sizes plus role annotations; pure data.

    ``client_axis``/``data_axis``/``model_axis`` name which mesh axis plays
    each role (or None when the role is absent).  The federation engines
    split the participating-client cohort over ``client_axis``;
    ``launch/sharding.py`` rules shard params over ``model_axis`` and
    batches over ``data_axis``.
    """

    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    client_axis: Optional[str] = None
    data_axis: Optional[str] = None
    model_axis: Optional[str] = None

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} / axes {self.axes} length mismatch")
        if len(set(self.axes)) != len(self.axes):
            raise ValueError(f"duplicate axis names in {self.axes}")
        for s, a in zip(self.shape, self.axes):
            if s < 1:
                raise ValueError(f"axis {a!r} has non-positive size {s}")
        for role, name in [("client_axis", self.client_axis),
                           ("data_axis", self.data_axis),
                           ("model_axis", self.model_axis)]:
            if name is not None and name not in self.axes:
                raise ValueError(
                    f"{role}={name!r} is not a mesh axis (axes: {self.axes})")

    # -- role-keyed sizes --------------------------------------------------

    def size(self, axis: Optional[str]) -> int:
        """Size of a named axis; 1 for None (an absent role is a size-1
        degenerate axis as far as divisibility/sharding math goes)."""
        if axis is None:
            return 1
        return self.shape[self.axes.index(axis)]

    @property
    def n_devices(self) -> int:
        return int(np.prod(self.shape))

    @property
    def client_size(self) -> int:
        return self.size(self.client_axis)

    @property
    def data_size(self) -> int:
        return self.size(self.data_axis)

    @property
    def model_size(self) -> int:
        return self.size(self.model_axis)

    def signature(self) -> str:
        """Stable id for engine-cache keys and logs."""
        dims = ",".join(f"{a}={s}" for a, s in zip(self.axes, self.shape))
        roles = ",".join(
            f"{r}:{n}" for r, n in [("client", self.client_axis),
                                    ("data", self.data_axis),
                                    ("model", self.model_axis)] if n)
        return f"{dims}[{roles}]" if roles else f"{dims}[]"

    # -- shipped layouts ---------------------------------------------------

    @staticmethod
    def clients(n_shards: int, axis_name: str = "clients") -> "MeshSpec":
        """1-D mesh over the FL participating-client axis."""
        return MeshSpec((n_shards,), (axis_name,), client_axis=axis_name)

    @staticmethod
    def host() -> "MeshSpec":
        """Degenerate 1x1 (data, model) mesh for smoke runs."""
        return MeshSpec((1, 1), ("data", "model"),
                        data_axis="data", model_axis="model")

    @staticmethod
    def single_pod(data: int = 16, model: int = 16) -> "MeshSpec":
        """One pod: (data, model) tensor/batch parallelism, no client axis."""
        return MeshSpec((data, model), ("data", "model"),
                        data_axis="data", model_axis="model")

    @staticmethod
    def multi_pod(pods: int = 2, data: int = 16, model: int = 16) -> "MeshSpec":
        """(pod, data, model): ``pod`` is the FL-cohort (client-role) axis."""
        return MeshSpec((pods, data, model), ("pod", "data", "model"),
                        client_axis="pod", data_axis="data",
                        model_axis="model")


_MESH_GRAMMAR = (
    "mesh spec grammar: 'clients' | 'clients:N' (1-D client mesh, N shards, "
    "0/omitted = auto) | 'host' (1x1 data,model) | 'pod:DxM' (single pod) | "
    "'pods:PxDxM' (multi-pod; pod = client-role axis)"
)


def parse_mesh(spec: str) -> MeshSpec:
    """Parse a ``--mesh`` CLI string into a MeshSpec (see _MESH_GRAMMAR).

    ``clients:0``/``clients`` returns the auto-clients marker spec: the
    engine factory replaces it with ``resolve_shards`` before touching
    the process group.
    """
    s = spec.strip().lower()
    head, _, tail = s.partition(":")
    try:
        if head == "clients":
            n = int(tail) if tail else 0
            if n < 0:
                raise ValueError
            return MeshSpec.clients(max(n, 1)) if n else _auto_clients_spec()
        if head == "host" and not tail:
            return MeshSpec.host()
        if head == "pod":
            d, m = (int(x) for x in tail.split("x"))
            return MeshSpec.single_pod(d, m)
        if head == "pods":
            p, d, m = (int(x) for x in tail.split("x"))
            return MeshSpec.multi_pod(p, d, m)
    except (ValueError, TypeError) as e:
        raise ValueError(f"bad mesh spec {spec!r}; {_MESH_GRAMMAR}") from e
    raise ValueError(f"unknown mesh spec {spec!r}; {_MESH_GRAMMAR}")


class _AutoClients(MeshSpec):
    """Marker subclass: 1-D client mesh whose shard count is resolved from
    (K', world size) by the engine factory (``clients``/``clients:0``)."""


def _auto_clients_spec() -> MeshSpec:
    return _AutoClients((1,), ("clients",), client_axis="clients")


def is_auto_clients(spec: MeshSpec) -> bool:
    return isinstance(spec, _AutoClients)


# the DeviceMeshes of the current default group, per (device type, shape,
# axes): building one creates a process group per axis, a collective call
# that every rank makes in the same order, so an engine rebuilt for another
# cohort size reuses the groups of its layout
_MESHES = {"world": None, "meshes": {}}


def resolve_mesh(spec: MeshSpec, device_type: Optional[str] = None):
    """MeshSpec -> ``torch.distributed.device_mesh.DeviceMesh`` over every
    rank of the initialized default process group, one rank per device.

    ``device_type`` defaults from the group's backend: "cuda" for NCCL,
    "cpu" otherwise.  Raises when no group is initialized, and when the
    world size is not ``spec.n_devices`` (with the grammar, so the caller
    can pick a spec that fits).
    """
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            f"mesh {spec.signature()} needs an initialized torch.distributed "
            "process group (torchrun, or repro_torch.launch.collectives."
            "init_world for one rank)")
    world = dist.get_world_size()
    if world != spec.n_devices:
        raise RuntimeError(
            f"mesh {spec.signature()} needs {spec.n_devices} ranks, the "
            f"process group has {world}: launch one rank per device (torchrun "
            f"--nproc-per-node {spec.n_devices}) or pick a spec of {world} "
            f"devices ({_MESH_GRAMMAR})")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if _MESHES["world"] is not dist.group.WORLD:  # a new default group
        _MESHES.update(world=dist.group.WORLD, meshes={})
    meshes = _MESHES["meshes"]
    key = (device_type, spec.shape, spec.axes)
    if key not in meshes:
        meshes[key] = init_device_mesh(device_type, spec.shape, mesh_dim_names=spec.axes)
    return meshes[key]


def make_host_mesh():
    """Degenerate 1x1 mesh for one-rank smoke runs."""
    return resolve_mesh(MeshSpec.host())


def make_client_mesh(n_shards: int, axis_name: str = "clients"):
    """1-D mesh over the FL participating-client axis."""
    return resolve_mesh(MeshSpec.clients(n_shards, axis_name))
