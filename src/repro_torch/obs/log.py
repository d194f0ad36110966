"""Structured logger for the observability layer (DESIGN.md §13).

One funnel for every human-facing line the stack used to ``print``
directly: the drivers' per-round progress lines, the examples' round
summaries, and the kernel-dispatch "auto resolved to" notice.  Each call
carries BOTH a preformatted human string (printed verbatim, so
format-sensitive consumers — the example-parity tests regex the
6-decimal ``loss=`` field — see exactly the bytes they always saw) and a
structured field dict that is mirrored as a JSON record into the active
trace directory when tracing is on.

Quiet mode suppresses the stdout line only; the structured record still
lands in the trace, so ``--quiet`` runs stay fully attributable.
"""
from __future__ import annotations

import json
from typing import Callable, Optional


class ObsLog:
    """Human line to stdout (unless quiet) + structured record to a sink.

    ``sink`` is a callable taking one JSON-serializable dict (the tracer
    attaches its event stream here); None drops the structured record.
    """

    def __init__(self, quiet: bool = False,
                 sink: Optional[Callable[[dict], None]] = None):
        self.quiet = quiet
        self._sink = sink

    def attach_sink(self, sink: Optional[Callable[[dict], None]]) -> None:
        self._sink = sink

    def info(self, msg: str, *, event: str = "log", logger=None, **fields):
        """Emit ``msg``.

        Default route is ``print`` (the drivers' verbose lines); passing a
        stdlib ``logger`` routes the human line there instead — used by
        the kernel-dispatch auto-resolution notice, whose consumers
        (caplog tests, library embedders) expect a ``logging`` record
        rather than stdout.  ``fields`` become the structured record.
        """
        if logger is not None:
            logger.info(msg)
        elif not self.quiet:
            print(msg)
        self._record(event, msg, fields)

    def debug(self, msg: str, *, event: str = "log", **fields):
        """Structured record only — never stdout.  For machine-facing
        notices (engine construction, cache promotion) that would
        otherwise change example output."""
        self._record(event, msg, fields)

    def _record(self, event: str, msg: str, fields: dict) -> None:
        if self._sink is None:
            return
        rec = {"k": "log", "event": event, "msg": msg}
        if fields:
            rec["fields"] = _jsonable(fields)
        self._sink(rec)


def _jsonable(obj):
    """Best-effort JSON coercion so a log call can never crash a run."""
    try:
        json.dumps(obj)
        return obj
    except (TypeError, ValueError):
        if isinstance(obj, dict):
            return {str(key): _jsonable(v) for key, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return [_jsonable(v) for v in obj]
        return repr(obj)
