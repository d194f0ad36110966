"""Host-side client-heterogeneity models (DESIGN.md §10).

Production federations are dominated by stragglers and intermittent
availability, not FLOPs: clients differ in compute speed by orders of
magnitude and are online only a fraction of the time.  This module gives
the simulator a *clock* for that world — per-client round durations and
on/off availability traces — without touching the federation's numerics.
Two implementations of one interface (``duration`` / ``is_online`` /
``next_online`` / ``sync_round_duration``, plus ``.cfg``/``.n`` for the
checkpoint fingerprint):

- ``ClientAvailability`` — the seeded generative model (lognormal speeds,
  exponential on/off renewal process);
- ``TraceAvailability`` — replay-from-file: real-world device traces
  (JSON on/off windows + per-client durations) replayed periodically,
  content-digest-stamped so checkpoint resume rejects a changed trace.

``make_availability`` resolves a config of either flavour; the generative
model's determinism story:

- **Deterministic per seed, independent streams.**  Every draw comes from
  RandomStates keyed by ``(seed, purpose[, client])``, never from the
  federation's participation RNG.  Enabling heterogeneity therefore never
  perturbs cohort or batch sampling — the property the sync-degenerate
  bitwise guarantee of ``repro.fl.async_`` rests on.
- **Pure function of the seed.**  Speeds are drawn once at construction;
  on/off traces are generated lazily per client from per-client
  RandomStates and only ever *extended* forward, so any query order (and
  any checkpoint/restore cut) observes the same trace.  Checkpointing the
  model needs no state.
- **Degenerate-cheap.**  ``availability=1.0`` and ``speed="fixed"`` skip
  the trace machinery entirely: every client is always online with the
  same constant duration — the configuration under which the async driver
  reproduces the synchronous history bitwise.

``ClientAvailability.sync_round_duration`` is the bulk-synchronous cost
model used by the sync driver's simulated clock: the server samples
obliviously and waits for every sampled client to come online and finish,
so one round costs max_i(wait_i + duration_i).  The async scheduler
(``repro.fl.scheduler``) instead dispatches only to online clients —
that asymmetry is exactly what the ``async-engine`` bench measures.
"""
from __future__ import annotations

import bisect
import hashlib
import json
from dataclasses import dataclass, replace
from pathlib import Path

import numpy as np

# seed-stream salts: keep the speed and trace streams disjoint from each
# other (and trivially from the federation's participation RandomState,
# which is seeded with the bare integer seed)
_SPEED_SALT = 0xA11C_0DE
_TRACE_SALT = 0x0F_F0


@dataclass(frozen=True)
class AvailabilityConfig:
    """Client heterogeneity knobs (all times in simulated seconds).

    The defaults are the *degenerate* configuration: fixed uniform speeds,
    always-online clients — the setting under which ``AsyncFederation``
    must reproduce the synchronous history bitwise (DESIGN.md §10).
    """

    speed: str = "fixed"  # "fixed" | "lognormal" per-client multipliers
    mean_duration: float = 1.0  # median client round duration
    sigma: float = 1.0  # lognormal sigma of the speed multipliers
    availability: float = 1.0  # steady-state online fraction; 1.0 = always on
    mean_on: float = 10.0  # mean online-stretch length (exponential)


class AvailabilityModel:
    """Shared interface + the bulk-synchronous cost model.

    Subclasses set ``cfg`` (a frozen dataclass — ``dataclasses.asdict`` of
    it is stamped into checkpoint fingerprints by the drivers) and ``n``,
    and implement ``duration`` / ``is_online`` / ``next_online``.
    """

    cfg = None
    n = 0

    def duration(self, client: int) -> float:
        raise NotImplementedError

    def is_online(self, client: int, t: float) -> bool:
        raise NotImplementedError

    def next_online(self, client: int, t: float) -> float:
        raise NotImplementedError

    @property
    def always_online(self) -> bool:
        """True iff ``is_online`` is identically True (every client, all t).

        An optimization contract, not a heuristic: the async scheduler's
        candidate scan is O(K) python-loop per dispatch event, which at
        fleet scale (K = 10^6) dominates the simulation.  A model that
        returns True here lets the scheduler build the candidate set
        vectorized (same ascending-id order, so the grouped ``rng.choice``
        draw — and the whole downstream history — stays bitwise
        identical).  Default False: correct for any model.
        """
        return False

    def sync_round_duration(self, client_ids, t: float) -> float:
        """Simulated wall-clock of one bulk-synchronous round from time t.

        The synchronous server samples availability-obliviously and waits
        for the full cohort: the round ends when the LAST sampled client
        has come online and finished, so the cost is
        max_i(next_online_i(t) + duration_i) - t.
        """
        ends = [self.next_online(int(i), t) + self.duration(int(i))
                for i in np.asarray(client_ids).tolist()]
        return max(ends) - t


class ClientAvailability(AvailabilityModel):
    """Per-client speeds + on/off traces, deterministic per (cfg, K, seed)."""

    def __init__(self, cfg: AvailabilityConfig, n_clients: int, seed: int):
        if not 0.0 < cfg.availability <= 1.0:
            raise ValueError(f"availability must be in (0, 1], got {cfg.availability}")
        if cfg.mean_duration <= 0.0 or cfg.mean_on <= 0.0:
            raise ValueError("mean_duration and mean_on must be positive")
        self.cfg = cfg
        self.n = n_clients
        self.seed = seed
        if cfg.speed == "fixed":
            mult = np.ones(n_clients)
        elif cfg.speed == "lognormal":
            rng = np.random.RandomState([seed, _SPEED_SALT])
            mult = rng.lognormal(mean=0.0, sigma=cfg.sigma, size=n_clients)
        else:
            raise ValueError(
                f"unknown speed model {cfg.speed!r}; choose 'fixed' or 'lognormal'"
            )
        # persistent per-client round duration (median = mean_duration)
        self.durations = cfg.mean_duration * mult
        self._always_on = cfg.availability >= 1.0
        # per-client lazily extended traces: (rng, start_on, boundaries)
        # where boundaries[j] is the cumulative time of the j-th on/off flip
        self._traces: dict = {}

    # -- durations ---------------------------------------------------------

    def duration(self, client: int) -> float:
        """Simulated duration of one dispatched client round."""
        return float(self.durations[client])

    # -- on/off traces -----------------------------------------------------

    def _trace(self, client: int, until: float):
        """Trace for ``client`` covering at least ``until`` sim-seconds.

        Alternating exponential on/off periods: mean_on online, and
        mean_off = mean_on * (1 - p) / p offline, which gives steady-state
        online fraction p.  Initial state is online with probability p.
        Extension only appends — the trace is a pure function of the seed.
        """
        tr = self._traces.get(client)
        if tr is None:
            rng = np.random.RandomState([self.seed, _TRACE_SALT, client])
            start_on = bool(rng.random_sample() < self.cfg.availability)
            tr = {"rng": rng, "start_on": start_on, "bounds": [0.0]}
            self._traces[client] = tr
        p = self.cfg.availability
        mean_off = self.cfg.mean_on * (1.0 - p) / p
        bounds = tr["bounds"]
        while bounds[-1] <= until:
            # state during the period being appended alternates from start_on
            on_now = tr["start_on"] ^ (len(bounds) % 2 == 0)
            mean = self.cfg.mean_on if on_now else mean_off
            bounds.append(bounds[-1] + float(tr["rng"].exponential(mean)))
        return tr

    @property
    def always_online(self) -> bool:
        return self._always_on

    def is_online(self, client: int, t: float) -> bool:
        """Online at time t?  Periods are half-open [start, end)."""
        if self._always_on:
            return True
        tr = self._trace(client, t)
        # bisect on the list itself: np.searchsorted would convert the
        # ever-growing trace to an array on EVERY query, degrading long
        # simulations quadratically with trace length
        j = bisect.bisect_right(tr["bounds"], t) - 1
        return tr["start_on"] ^ (j % 2 == 1)

    def next_online(self, client: int, t: float) -> float:
        """Earliest time >= t at which ``client`` is online."""
        if self._always_on:
            return t
        if self.is_online(client, t):
            return t
        tr = self._trace(client, t)
        bounds = tr["bounds"]
        # bounds[-1] > t after _trace, so this index always exists: it is
        # the end of the offline period containing t == the next on-start
        # (periods strictly alternate)
        j = bisect.bisect_right(bounds, t)
        return float(bounds[j])


# ---------------------------------------------------------------------------
# Trace-driven availability: replay real-world device traces from a file
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TraceAvailabilityConfig:
    """Replay-from-file availability (``--availability trace:<path>``).

    ``digest`` is the sha256 of the trace file, filled by
    ``TraceAvailability`` at load time: ``dataclasses.asdict(model.cfg)``
    lands in the checkpoint fingerprint (repro.fl.runtime), so resuming
    against a moved OR edited trace file is rejected — the replayed clock
    would not be a bitwise continuation.
    """

    path: str
    digest: str = ""


class TraceAvailability(AvailabilityModel):
    """Replays on/off windows and per-client durations from a JSON file.

    File format (see examples/traces/ for a bundled sample)::

        {"period": 20.0,                    # optional; default max end
         "clients": [
           {"duration": 1.0,                # simulated round duration
            "online": [[0.0, 8.0], [12.0, 20.0]]},   # half-open [s, e)
           ...]}

    Windows must be sorted, non-overlapping and within [0, period]; the
    pattern repeats every ``period`` simulated seconds, so simulations
    longer than the recorded trace keep replaying it (the standard
    device-trace protocol).  A federation larger than the trace maps
    client i onto recorded trace ``i % len(clients)``.  No RNG anywhere:
    the model is a pure function of the file, which is why the content
    digest alone fingerprints it.
    """

    def __init__(self, cfg: TraceAvailabilityConfig, n_clients: int,
                 seed: int = 0):
        del seed  # replay is deterministic; kept for interface symmetry
        raw = Path(cfg.path).read_bytes()
        digest = hashlib.sha256(raw).hexdigest()
        if cfg.digest and cfg.digest != digest:
            raise ValueError(
                f"trace file {cfg.path} has digest {digest[:12]}..., but the "
                f"config pins {cfg.digest[:12]}... - the trace changed on disk"
            )
        self.cfg = replace(cfg, digest=digest)
        self.n = n_clients
        data = json.loads(raw.decode("utf-8"))
        clients = data.get("clients")
        if not clients:
            raise ValueError(f"trace file {cfg.path} has no 'clients' entries")
        ends = [w[1] for c in clients for w in c.get("online", [])]
        self.period = float(data.get("period") or (max(ends) if ends else 0.0))
        if self.period <= 0.0:
            raise ValueError(
                f"trace file {cfg.path} needs a positive period (explicit "
                "'period' or at least one online window)")
        self._durations = []
        self._windows = []
        for j, c in enumerate(clients):
            dur = float(c.get("duration", 1.0))
            if dur <= 0.0:
                raise ValueError(f"trace client {j}: non-positive duration {dur}")
            wins = [(float(s), float(e)) for s, e in c.get("online", [])]
            prev_end = 0.0
            for s, e in wins:
                if not (0.0 <= s < e <= self.period) or s < prev_end:
                    raise ValueError(
                        f"trace client {j}: windows must be sorted, "
                        f"non-overlapping, within [0, {self.period}] "
                        f"(offending window [{s}, {e}))")
                prev_end = e
            self._durations.append(dur)
            self._windows.append(wins)

    def _client(self, client: int) -> int:
        return client % len(self._windows)

    def duration(self, client: int) -> float:
        return self._durations[self._client(client)]

    def is_online(self, client: int, t: float) -> bool:
        tt = t % self.period
        for s, e in self._windows[self._client(client)]:
            if s <= tt < e:
                return True
        return False

    def next_online(self, client: int, t: float) -> float:
        """Earliest time >= t at which ``client`` is online (replay wraps:
        a client with no windows never comes online — rejected upfront by
        the scheduler's deadlock error rather than looping forever)."""
        wins = self._windows[self._client(client)]
        if not wins:
            return float("inf")
        cycle, tt = divmod(t, self.period)
        for s, e in wins:
            if tt < e:
                return t if s <= tt else cycle * self.period + s
        # past the last window: first window of the next cycle
        return (cycle + 1) * self.period + wins[0][0]


def make_availability(cfg, n_clients: int, seed: int) -> AvailabilityModel:
    """Resolve an availability config of either flavour to its model."""
    if isinstance(cfg, TraceAvailabilityConfig):
        return TraceAvailability(cfg, n_clients, seed)
    if isinstance(cfg, AvailabilityConfig):
        return ClientAvailability(cfg, n_clients, seed)
    raise TypeError(
        f"availability config must be AvailabilityConfig or "
        f"TraceAvailabilityConfig, got {type(cfg).__name__}"
    )
