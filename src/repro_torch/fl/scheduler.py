"""Availability-aware discrete-event round scheduler (DESIGN.md §10/§11).

Host-side bookkeeping for the asynchronous federation driver
(``repro.fl.async_``): *when* clients run, never *what* they compute.
Three responsibilities:

- **Grouped dispatch.**  ``dispatch_group`` fills the free concurrency
  slots from the currently online, idle clients with ONE
  ``rng.choice(candidates, m, replace=False)`` draw on the federation's
  participation RandomState.  Grouping matters twice over: clients
  dispatched together share the same broadcast version, so the traced
  client phase runs them through the existing ``FederationEngine``
  backends as one stacked micro-cohort (one jitted SPMD launch, one
  batched §9 kernel call — never K' single-client launches); and in the
  degenerate configuration (everyone online, uniform speeds, concurrency
  = K') the candidate set is exactly ``arange(K)``, making the draw — and
  therefore the whole downstream RNG stream — bitwise identical to the
  synchronous driver's ``rng.choice(K, K', replace=False)``.
- **Completion events.**  A min-heap of ``(completion_time, seq, client,
  pod)`` tuples; ``seq`` is the global dispatch order, so simultaneous
  completions pop in dispatch order — which is what keeps the degenerate
  configuration's upload stacking order identical to the synchronous
  engine output.  ``pop_pod_completions`` pops the *per-pod micro-cohort*
  of every event sharing both the minimal completion time and the pod of
  its earliest-dispatched event, so each pod drains its own completion
  stream (DESIGN.md §11) and deliveries (state scatter + eval) batch
  through the engines per pod.  ``pop_completions`` (the pod-oblivious
  variant, == the single-pod behaviour) remains for callers that want
  the whole timestamp cohort.
- **Wakeups.**  When slots are free but every idle client is offline,
  ``next_dispatch_time`` gives the earliest on-transition to advance the
  clock to.

**Pods** (``n_pods > 1``, the multi-pod `(pod, data, model)` mesh):
dispatched clients are assigned to pods by filling each pod's free slots
in pod order with a *contiguous* run of the single grouped draw — so in
the degenerate configuration pod p holds exactly the p-th contiguous
block of the synchronous cohort, and draining pods in dispatch order
reassembles the synchronous upload order bit-for-bit.  The total
``concurrency`` is split across pods as evenly as possible (earlier pods
take the remainder).

The scheduler is checkpointable: ``state()``/``restore_state`` round-trip
the heap (times/seqs/ids/pods) and the dispatch counter through plain
numpy arrays (repro.utils.checkpoint), and the availability model itself
needs no state (pure function of the seed — see repro.fl.availability).
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.fl.availability import AvailabilityModel
from repro_torch.obs import NOOP


class RoundScheduler:
    """Dispatch/completion bookkeeping over an ``AvailabilityModel``."""

    def __init__(self, availability: AvailabilityModel, concurrency: int,
                 n_pods: int = 1):
        if concurrency < 1:
            raise ValueError(f"concurrency must be >= 1, got {concurrency}")
        if n_pods < 1:
            raise ValueError(f"n_pods must be >= 1, got {n_pods}")
        if n_pods > concurrency:
            raise ValueError(
                f"n_pods={n_pods} exceeds concurrency={concurrency}: a pod "
                "without a dispatch slot would never receive work"
            )
        self.avail = availability
        self.concurrency = concurrency
        self.n_pods = n_pods
        # per-pod slot quota: as even as possible, earlier pods take the
        # remainder (degenerate config: concurrency = K' divisible by pods)
        base, rem = divmod(concurrency, n_pods)
        self._quota = [base + (1 if p < rem else 0) for p in range(n_pods)]
        self._heap: List[Tuple[float, int, int, int]] = []
        self._seq = 0
        self.inflight: Dict[int, int] = {}  # client -> pod
        # observability facade (swapped in by the async driver): a client's
        # dispatch→completion interval is fully known at dispatch (the
        # simulator delays only *delivery*), so the per-client sim-time
        # track is emitted right here (DESIGN.md §13)
        self.obs = NOOP

    # -- dispatch ----------------------------------------------------------

    def free_slots(self) -> int:
        return self.concurrency - len(self.inflight)

    def _pod_inflight(self) -> List[int]:
        counts = [0] * self.n_pods
        for p in self.inflight.values():
            counts[p] += 1
        return counts

    def candidates(self, t: float) -> np.ndarray:
        """Online, idle client ids at time t (sorted — ascending id order,
        matching the synchronous sampler's arange population).

        Always-online models take the vectorized path: a boolean mask over
        ``arange(K)`` instead of a per-client python loop, which is what
        makes fleet-scale (K = 10^6) dispatch tractable.  Both paths
        produce the identical ascending array, so the grouped
        ``rng.choice`` draw is bitwise the same either way.
        """
        if self.avail.always_online:
            if not self.inflight:
                return np.arange(self.avail.n, dtype=np.int64)
            idle = np.ones(self.avail.n, dtype=bool)
            idle[np.fromiter(self.inflight, np.int64, len(self.inflight))] = False
            return np.flatnonzero(idle).astype(np.int64)
        return np.asarray(
            [i for i in range(self.avail.n)
             if i not in self.inflight and self.avail.is_online(i, t)],
            np.int64,
        )

    def dispatch_group(self, t: float, rng: np.random.RandomState) -> np.ndarray:
        """Sample and dispatch a micro-cohort at time t; returns its ids.

        One grouped ``rng.choice`` per event (never per client) on the
        federation's shared participation RandomState — see module
        docstring for why.  The draw is assigned to pods as contiguous
        runs filling each pod's free slots in pod order.  Returns an empty
        array when no slots are free or every idle client is offline.
        """
        want = self.free_slots()
        if want <= 0:
            return np.empty(0, np.int64)
        cands = self.candidates(t)
        m = min(want, len(cands))
        if m == 0:
            return np.empty(0, np.int64)
        ids = rng.choice(cands, m, replace=False)
        counts = self._pod_inflight()
        pos = 0
        for p in range(self.n_pods):
            take = min(self._quota[p] - counts[p], m - pos)
            for i in ids[pos:pos + take].tolist():
                td = t + self.avail.duration(i)
                heapq.heappush(self._heap, (td, self._seq, i, p))
                self._seq += 1
                self.inflight[i] = p
                self.obs.client_span(i, "inflight", t, td, pod=p)
            pos += take
        assert pos == m, (pos, m, self._quota, counts)
        return ids

    # -- completions -------------------------------------------------------

    def next_completion_time(self) -> Optional[float]:
        return self._heap[0][0] if self._heap else None

    def pop_completions(self) -> Tuple[float, List[int]]:
        """Pop the micro-cohort of ALL events at the minimal completion
        time (every pod), in dispatch (seq) order; marks them idle again."""
        if not self._heap:
            raise RuntimeError("pop_completions on an empty event heap")
        t = self._heap[0][0]
        ids: List[int] = []
        while self._heap and self._heap[0][0] == t:
            _, _, i, _ = heapq.heappop(self._heap)
            ids.append(i)
            self.inflight.pop(i, None)
        return t, ids

    def pop_pod_completions(self) -> Tuple[float, int, List[int]]:
        """Pop ONE pod's micro-cohort: all events sharing the minimal
        completion time AND the pod of the earliest-dispatched such event,
        in dispatch (seq) order (DESIGN.md §11 — each pod drains its own
        completion stream).  Events of other pods at the same time stay
        queued for the next pop."""
        if not self._heap:
            raise RuntimeError("pop_pod_completions on an empty event heap")
        t = self._heap[0][0]
        pod = self._heap[0][3]
        ids: List[int] = []
        deferred = []
        while self._heap and self._heap[0][0] == t:
            ev = heapq.heappop(self._heap)
            if ev[3] == pod:
                ids.append(ev[2])
                self.inflight.pop(ev[2], None)
            else:
                deferred.append(ev)
        for ev in deferred:
            heapq.heappush(self._heap, ev)
        return t, pod, ids

    def next_dispatch_time(self, t: float) -> Optional[float]:
        """Earliest time > t when an idle client comes online; None when
        every client is in flight OR no idle client ever comes online
        (a trace model may return inf for permanently-offline clients —
        surfaced as None so callers hit their deadlock error instead of
        advancing the clock to infinity)."""
        if len(self.inflight) >= self.avail.n:
            return None
        if self.avail.always_online:
            # some client is idle and every client is online: dispatchable
            # immediately (``next_online(i, t) == t`` for all i)
            return t
        tn = min(self.avail.next_online(i, t)
                 for i in range(self.avail.n) if i not in self.inflight)
        return tn if np.isfinite(tn) else None

    # -- checkpointing -----------------------------------------------------

    def state(self) -> dict:
        """Heap + counter as arrays (npz-exact; repro.utils.checkpoint)."""
        ev = sorted(self._heap)
        return {
            "times": np.asarray([e[0] for e in ev], np.float64),
            "seqs": np.asarray([e[1] for e in ev], np.int64),
            "ids": np.asarray([e[2] for e in ev], np.int64),
            "pods": np.asarray([e[3] for e in ev], np.int64),
            "seq_counter": np.int64(self._seq),
        }

    def restore_state(self, state: dict) -> None:
        times = np.asarray(state["times"], np.float64)
        seqs = np.asarray(state["seqs"], np.int64)
        ids = np.asarray(state["ids"], np.int64)
        pods = np.asarray(state["pods"], np.int64)
        self._heap = [(float(t), int(s), int(i), int(p))
                      for t, s, i, p in zip(times, seqs, ids, pods)]
        heapq.heapify(self._heap)
        self._seq = int(state["seq_counter"])
        self.inflight = {int(i): int(p) for i, p in zip(ids, pods)}
