"""Federation engine (port of ``repro/fl/engine.py``, ``VmapBackend`` only).

``VmapBackend`` runs the per-client phases of a round on one device: the
method's one-client functions are mapped over the gathered cohort with
``torch.func.vmap``; the server broadcast is passed unbatched.  The
``shard_map`` and ``mesh`` backends come with the multi-device slice
(ROADMAP.md queue 1, item 16).
"""
from __future__ import annotations

import torch.func

BACKENDS = ("vmap",)


class VmapBackend:
    """Single-device backend: one ``torch.func.vmap`` over the cohort."""

    name = "vmap"

    def client_phase(self, one_client, gathered_states, broadcast, batches):
        return torch.func.vmap(one_client, in_dims=(0, None, 0))(
            gathered_states, broadcast, batches)

    def eval_phase(self, one_eval, states, broadcast, test_sets):
        return torch.func.vmap(one_eval, in_dims=(0, None, 0))(
            states, broadcast, test_sets)

    def describe(self):
        return {"backend": self.name, "shards": 1}


def make_engine(backend: str) -> VmapBackend:
    if backend == "vmap":
        return VmapBackend()
    if backend in ("shard_map", "mesh"):
        raise NotImplementedError(
            f"backend={backend!r} is not ported to repro_torch yet (the "
            "multi-device slice, ROADMAP.md queue 1 item 16); use 'vmap'")
    raise ValueError(f"unknown FL backend {backend!r}; choose from {BACKENDS}")
