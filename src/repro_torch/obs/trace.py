"""Tracer: nested wall-clock/sim-time spans with a Chrome-trace exporter
(DESIGN.md §13).

Event stream semantics
----------------------

The tracer appends newline-delimited JSON records to
``<trace_dir>/events.jsonl``; ``meta.json`` beside it stamps the run's
config fingerprint (the same facets the checkpoint manifest stamps).
Re-opening an existing trace directory with a MATCHING fingerprint
appends — with a ``resume`` marker event at the cut — instead of
clobbering; a mismatched fingerprint raises, mirroring the checkpoint
restore rejection (a trace mixing two configs is not a timeline).

Two clocks, one file:

- **wall clock** — span ``ts`` is epoch microseconds
  (``time.time_ns() // 1000``), so appended segments from a resumed
  process stay globally monotonic; ``dur`` comes from ``perf_counter``.
- **sim time** — the discrete-event simulated clock of the async
  scheduler (and the sync driver's straggler model).  ``client_span``
  records an interval purely in sim seconds; server records may carry a
  ``sim`` annotation alongside their wall timestamp.

``export_chrome`` renders both as one Chrome-trace/Perfetto JSON
(``trace.json``): wall-clock records as process "server (wall clock)"
with one thread per track, sim-time records as process "clients (sim
time)" with one thread per client — load either in Perfetto or
chrome://tracing.  Sim seconds map to trace microseconds 1:1e6, so a
sim-second reads as a second in the viewer.
"""
from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path
from typing import List, Optional

SCHEMA_VERSION = 1


def _wall_us() -> int:
    return time.time_ns() // 1000


class Tracer:
    """Append-mode JSONL event stream under ``trace_dir``."""

    def __init__(self, trace_dir, fingerprint: Optional[dict] = None):
        self.dir = Path(trace_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        meta_path = self.dir / "meta.json"
        events = self.dir / "events.jsonl"
        resuming = meta_path.exists()
        if resuming:
            meta = json.loads(meta_path.read_text())
            if fingerprint is not None and meta.get("fingerprint") != fingerprint:
                raise ValueError(
                    f"trace at {self.dir} was recorded with fingerprint "
                    f"{meta.get('fingerprint')}, but this run is configured "
                    f"with {fingerprint}; appending across a config change "
                    "would mix two incomparable timelines (use a fresh "
                    "--trace-dir)"
                )
        else:
            meta = {"schema": SCHEMA_VERSION, "fingerprint": fingerprint}
            meta_path.write_text(json.dumps(meta, indent=1, default=str))
        self._f = open(events, "a")
        self._stack: List[dict] = []
        if resuming:
            self.event("resume", cat="marker")

    # -- record emission ---------------------------------------------------

    def _write(self, rec: dict) -> None:
        self._f.write(json.dumps(rec) + "\n")

    def sink(self, rec: dict) -> None:
        """Raw-record sink (the structured-log mirror attaches here)."""
        rec = dict(rec)
        rec.setdefault("ts", _wall_us())
        self._write(rec)

    @contextlib.contextmanager
    def span(self, name: str, track: str = "server",
             sim: Optional[float] = None, **args):
        """Nested wall-clock span (context manager); ``depth`` is the
        nesting level at entry, recorded so consumers need not rebuild
        the stack from timestamps."""
        rec = {"k": "span", "name": name, "track": track,
               "ts": _wall_us(), "depth": len(self._stack)}
        if sim is not None:
            rec["sim"] = float(sim)
        if args:
            rec["args"] = args
        self._stack.append(rec)
        t0 = time.perf_counter_ns()
        try:
            yield rec
        finally:
            rec["dur"] = (time.perf_counter_ns() - t0) // 1000
            self._stack.pop()
            self._write(rec)

    def complete(self, name: str, ts_us: int, dur_us: int,
                 track: str = "server", sim: Optional[float] = None,
                 **args) -> None:
        """Pre-timed wall-clock span (the driver's phase timer)."""
        rec = {"k": "span", "name": name, "track": track,
               "ts": int(ts_us), "dur": int(dur_us),
               "depth": len(self._stack)}
        if sim is not None:
            rec["sim"] = float(sim)
        if args:
            rec["args"] = args
        self._write(rec)

    def event(self, name: str, cat: str = "event", track: str = "server",
              sim: Optional[float] = None, **args) -> None:
        """Instant event on the wall clock (optionally sim-annotated)."""
        rec = {"k": "ev", "name": name, "cat": cat, "track": track,
               "ts": _wall_us()}
        if sim is not None:
            rec["sim"] = float(sim)
        if args:
            rec["args"] = args
        self._write(rec)

    def client_span(self, client: int, name: str, sim0: float, sim1: float,
                    **args) -> None:
        """Sim-time interval on a per-client track (async lifecycle)."""
        rec = {"k": "cspan", "name": name, "client": int(client),
               "sim0": float(sim0), "sim1": float(sim1), "ts": _wall_us()}
        if args:
            rec["args"] = args
        self._write(rec)

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.flush()
        self._f.close()


# ---------------------------------------------------------------------------
# Chrome-trace / Perfetto export
# ---------------------------------------------------------------------------

_WALL_PID = 1
_SIM_PID = 2


def read_events(trace_dir) -> List[dict]:
    out = []
    with open(Path(trace_dir) / "events.jsonl") as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def export_chrome(trace_dir, out_path=None) -> Path:
    """Render ``events.jsonl`` as Chrome-trace JSON (``trace.json``).

    Wall-clock spans/events land under pid 1 with one tid per track;
    sim-time client spans land under pid 2 with tid = client id (sim
    seconds scaled to trace µs); server records carrying a ``sim``
    annotation are mirrored as instants onto pid 2's "server" thread, so
    dispatch/flush structure lines up with the client tracks.
    """
    trace_dir = Path(trace_dir)
    events = read_events(trace_dir)
    out: List[dict] = [
        {"ph": "M", "pid": _WALL_PID, "name": "process_name",
         "args": {"name": "server (wall clock)"}},
        {"ph": "M", "pid": _SIM_PID, "name": "process_name",
         "args": {"name": "clients (sim time)"}},
        {"ph": "M", "pid": _SIM_PID, "tid": 0, "name": "thread_name",
         "args": {"name": "server (sim)"}},
    ]
    tids = {}

    def tid_of(track: str) -> int:
        tid = tids.get(track)
        if tid is None:
            tid = tids[track] = len(tids) + 1
            out.append({"ph": "M", "pid": _WALL_PID, "tid": tid,
                        "name": "thread_name", "args": {"name": track}})
        return tid

    clients = set()
    for rec in events:
        kind = rec.get("k")
        args = dict(rec.get("args", {}))
        if "sim" in rec:
            args["sim"] = rec["sim"]
        if kind == "span":
            out.append({"ph": "X", "pid": _WALL_PID,
                        "tid": tid_of(rec.get("track", "server")),
                        "name": rec["name"], "cat": "wall",
                        "ts": rec["ts"], "dur": rec.get("dur", 0),
                        "args": args})
            if "sim" in rec:
                out.append({"ph": "i", "pid": _SIM_PID, "tid": 0, "s": "t",
                            "name": rec["name"], "cat": "sim",
                            "ts": int(rec["sim"] * 1e6), "args": args})
        elif kind == "ev":
            out.append({"ph": "i", "pid": _WALL_PID,
                        "tid": tid_of(rec.get("track", "server")),
                        "s": "t", "name": rec["name"],
                        "cat": rec.get("cat", "event"),
                        "ts": rec["ts"], "args": args})
            if "sim" in rec:
                out.append({"ph": "i", "pid": _SIM_PID, "tid": 0, "s": "t",
                            "name": rec["name"], "cat": "sim",
                            "ts": int(rec["sim"] * 1e6), "args": args})
        elif kind == "cspan":
            c = int(rec["client"])
            if c not in clients:
                clients.add(c)
                out.append({"ph": "M", "pid": _SIM_PID, "tid": c + 1,
                            "name": "thread_name",
                            "args": {"name": f"client {c}"}})
            out.append({"ph": "X", "pid": _SIM_PID, "tid": c + 1,
                        "name": rec["name"], "cat": "sim",
                        "ts": int(rec["sim0"] * 1e6),
                        "dur": max(int((rec["sim1"] - rec["sim0"]) * 1e6), 1),
                        "args": args})
        # "log" records are trace-dir artifacts, not timeline entries

    path = Path(out_path) if out_path else trace_dir / "trace.json"
    path.write_text(json.dumps(
        {"traceEvents": out, "displayTimeUnit": "ms"}))
    return path
