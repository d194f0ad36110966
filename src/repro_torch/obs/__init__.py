"""repro_torch.obs — zero-overhead-when-disabled observability.

Port of ``repro/obs/__init__.py``; ``log``, ``metrics`` and ``trace`` are
byte-equal copies of ``repro``'s (framework-free), so the trace directory
(``events.jsonl``, ``meta.json``, ``metrics.jsonl``) has ``repro``'s schema
and ``scripts/trace_report.py`` reads it unchanged.  Two replacements:
``timed`` waits for its outputs with ``torch.cuda.synchronize`` on their
device (a no-op for CPU tensors), and the profile window is a
``torch.profiler`` capture written under ``<trace_dir>/torch_profile``.

Three instruments behind one ``Obs`` facade:

- ``Tracer`` (``repro_torch.obs.trace``): nested wall-clock spans + discrete
  sim-time client tracks, JSONL event stream, Chrome-trace/Perfetto
  export, checkpoint-style fingerprint stamping with resume-append.
- ``MetricsRegistry`` (``repro_torch.obs.metrics``): counters/gauges/
  histograms with a per-round JSONL snapshot sink.
- ``ObsLog`` (``repro_torch.obs.log``): the structured logger every ad-hoc
  driver print routes through (quiet mode suppresses stdout only).

The hard contract (tests/test_torch_obs.py): observability NEVER
touches computed values.  Every instrument reads host-side numbers the run
already produced; the only on-path effect of enabling it is wall-clock
(``timed`` synchronizes between phases so span durations are honest).  With it
off (``FLRunConfig.obs = None``, the default) the drivers hold the
shared ``NOOP`` facade: no files, no objects, no extra synchronization —
training histories are bitwise identical to an uninstrumented build.

Levels: ``off`` < ``round`` (round spans + metrics) < ``phase``
(+ per-phase spans with device-synchronized boundaries) < ``kernel``
(+ NVTX ranges and ``kernel`` events around kernel call sites,
``repro_torch.kernels.dispatch.kernel_scope``).
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Optional

from repro_torch.obs.log import ObsLog
from repro_torch.obs.metrics import Histogram, MetricsRegistry, read_metrics
from repro_torch.obs.trace import Tracer, export_chrome, read_events

__all__ = [
    "OBS_LEVELS", "ObsConfig", "Obs", "NOOP", "make_obs", "as_obs_config",
    "get_obs", "ObsLog", "MetricsRegistry", "Histogram", "Tracer",
    "export_chrome", "read_events", "read_metrics",
    "LEVEL_OFF", "LEVEL_ROUND", "LEVEL_PHASE", "LEVEL_KERNEL",
]

OBS_LEVELS = ("off", "round", "phase", "kernel")
LEVEL_OFF, LEVEL_ROUND, LEVEL_PHASE, LEVEL_KERNEL = range(4)


@dataclass(frozen=True)
class ObsConfig:
    """Observability knobs, nested under ``FLRunConfig.obs``.

    ``trace_dir``: event-stream directory ("" = no tracing).  The drivers
    stamp it with the run's config fingerprint (``meta.json``); reopening
    with a matching fingerprint appends (a ``resume`` marker event marks
    the cut), a mismatch raises — mirroring checkpoint-restore rejection.
    Deliberately NOT part of the checkpoint fingerprint itself: resuming
    a run with tracing newly enabled (or disabled) is always allowed.

    ``metrics``: metrics.jsonl path; "" defaults to
    ``<trace_dir>/metrics.jsonl`` when tracing (and to off otherwise).

    ``level``: one of ``OBS_LEVELS`` — see the module docstring.

    ``quiet``: suppress the drivers' stdout progress lines (structured
    records still land in the trace).

    ``profile_round``: 0-based round/version index to wrap in a
    ``torch.profiler`` capture (a Chrome trace written under
    ``<trace_dir>/torch_profile``); -1 = off.  Round 0 carries cuDNN's
    first-call set-up, so 1 is the first steady round.
    """

    trace_dir: str = ""
    metrics: str = ""
    level: str = "phase"
    quiet: bool = False
    profile_round: int = -1

    def __post_init__(self):
        if self.level not in OBS_LEVELS:
            raise ValueError(
                f"obs level must be one of {OBS_LEVELS}, got {self.level!r}"
            )


def as_obs_config(obs) -> Optional[ObsConfig]:
    """Resolve ``FLRunConfig.obs``: None passes through (disabled)."""
    if obs is None or isinstance(obs, ObsConfig):
        return obs
    if isinstance(obs, dict):
        return ObsConfig(**obs)
    raise TypeError(
        f"obs must be None, an ObsConfig, or a kwargs dict; got "
        f"{type(obs).__name__}"
    )


_NULL_CTX = contextlib.nullcontext()


class Obs:
    """The facade the drivers thread through every layer.

    Constructed eagerly (``make_obs``) so the level/quiet knobs resolve
    at federation construction; file handles open in ``open()``, which
    the drivers call once the run fingerprint is known.  The shared
    ``NOOP`` instance (``Obs(None)``) is what a federation without an
    ``ObsConfig`` holds: every method is a cheap guard-and-return.
    """

    def __init__(self, cfg: Optional[ObsConfig]):
        self.cfg = cfg
        self.level = LEVEL_OFF
        self.enabled = False
        if cfg is not None and cfg.level != "off" and (
                cfg.trace_dir or cfg.metrics):
            self.level = OBS_LEVELS.index(cfg.level)
            self.enabled = True
        self.log = ObsLog(quiet=bool(cfg and cfg.quiet))
        self.tracer: Optional[Tracer] = None
        self.metrics: Optional[MetricsRegistry] = None
        # last registry snapshot, stashed by close() so callers that want
        # the final numbers (the bench harness embedding them in
        # BENCH_*.json) don't have to re-read metrics.jsonl
        self.final_metrics: Optional[dict] = None
        self._profiler = None

    # -- lifecycle ---------------------------------------------------------

    def open(self, fingerprint: Optional[dict] = None) -> "Obs":
        """Open the sinks (idempotent).  ``fingerprint`` is stamped into
        (and checked against) the trace's ``meta.json``."""
        if not self.enabled:
            return self
        if self.cfg.trace_dir and self.tracer is None:
            self.tracer = Tracer(self.cfg.trace_dir, fingerprint=fingerprint)
            self.log.attach_sink(self.tracer.sink)
            _set_global(self)
        metrics_path = self.cfg.metrics or (
            str(Path(self.cfg.trace_dir) / "metrics.jsonl")
            if self.cfg.trace_dir else "")
        if metrics_path and self.metrics is None:
            self.metrics = MetricsRegistry(metrics_path)
        return self

    def close(self) -> None:
        """Flush + close sinks and export the Chrome trace (idempotent;
        the exported ``trace.json`` is regenerated from the FULL event
        stream, so a resumed run exports one combined timeline)."""
        if self.metrics is not None:
            self.final_metrics = self.metrics.snapshot()
            self.metrics.close()
            self.metrics = None
        if self.tracer is not None:
            self.log.attach_sink(None)
            self.tracer.close()
            export_chrome(self.tracer.dir)
            self.tracer = None
            if _GLOBAL is self:
                _set_global(NOOP)

    # -- recording ---------------------------------------------------------

    def span(self, name: str, **kw):
        """Nested wall-clock span at ``round`` level and above."""
        if self.tracer is None or self.level < LEVEL_ROUND:
            return _NULL_CTX
        return self.tracer.span(name, **kw)

    def timed(self, name: str, fn, *args, sync: bool = True, **meta):
        """Run ``fn(*args)`` under a phase span (level ``phase``+).

        ``sync`` waits for the card to finish the outputs so the span
        measures the phase's actual device time, not its launch time —
        the documented wall-clock-only cost of enabling phase tracing.  ``sync=False``
        is for phases whose deferral IS the design (the store's
        overlapped d2h scatter).  Below phase level this is exactly
        ``fn(*args)``.
        """
        if self.tracer is None or self.level < LEVEL_PHASE:
            return fn(*args)
        ts = time.time_ns() // 1000
        t0 = time.perf_counter_ns()
        out = fn(*args)
        if sync:
            _synchronize(out)
        self.tracer.complete(name, ts, (time.perf_counter_ns() - t0) // 1000,
                             **meta)
        return out

    def event(self, name: str, **kw) -> None:
        if self.tracer is not None and self.level >= LEVEL_ROUND:
            self.tracer.event(name, **kw)

    def client_span(self, client: int, name: str, sim0: float, sim1: float,
                    **args) -> None:
        if self.tracer is not None and self.level >= LEVEL_ROUND:
            self.tracer.client_span(client, name, sim0, sim1, **args)

    def flush_metrics(self, step=None, **extra) -> None:
        if self.metrics is not None:
            self.metrics.flush(step=step, **extra)

    def flush(self) -> None:
        """Push buffered trace events to disk (the drivers call this per
        round so a crashed run still leaves a readable timeline)."""
        if self.tracer is not None:
            self.tracer.flush()

    # -- torch.profiler window (--profile-round) --------------------------

    def profile_round_start(self, t: int) -> None:
        if (self._profiler is not None or self.tracer is None
                or self.cfg.profile_round < 0 or t != self.cfg.profile_round):
            return
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        # no catch: a profiler that fails to start on the card is an error
        self._profiler = torch.profiler.profile(activities=acts)
        self._profiler.start()
        self.event("profile_start", round=t)

    def profile_round_end(self, t: int) -> None:
        if self._profiler is None:
            return
        prof, self._profiler = self._profiler, None
        prof.stop()
        out = self.tracer.dir / "torch_profile"
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out / f"round_{t:05d}.json"))
        self.event("profile_stop", round=t)


def _synchronize(tree) -> None:
    """Wait for the card to finish the first CUDA tensor found in ``tree``
    (dicts, tuples, lists and NamedTuples of tensors); CPU tensors and
    host values need no wait."""
    import torch

    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                torch.cuda.synchronize(x.device)
                return
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (tuple, list)):
            stack.extend(x)


NOOP = Obs(None)

_GLOBAL: Obs = NOOP


def _set_global(obs: Obs) -> None:
    global _GLOBAL
    _GLOBAL = obs


def get_obs() -> Obs:
    """The most recently opened tracing facade (NOOP otherwise) — the
    hook layers without a driver handle (kernel dispatch) report to."""
    return _GLOBAL


def make_obs(obs) -> Obs:
    """``FLRunConfig.obs`` -> an ``Obs`` facade (shared NOOP when None)."""
    cfg = as_obs_config(obs)
    if cfg is None:
        return NOOP
    return Obs(cfg)
