"""Thread-safe host-side span tracing in Chrome trace-event format, ported
from :mod:`crosscoder_tpu.obs.trace`.

The hot loops (the train step's launches, the batch production on the
prefetch worker, the buffer's refill, the checkpoint writer, the watchdog's
runners) run on several host threads. :class:`SpanTracer` gives each the
same primitive, a context-manager span that

- records a Chrome trace-event "complete" entry (``ph: "X"``) with
  microsecond ``ts``/``dur`` and the recording thread's ``tid``, so
  ``trace.json`` opens in Perfetto or ``chrome://tracing`` and
  ``scripts/trace_report.py`` summarizes it;
- enters :func:`torch.profiler.record_function` of the span's name, so
  inside a captured profiler window (:mod:`crosscoder_tpu_torch.obs.profiler`)
  the host spans line up with the kernels on the device timeline;
- feeds a :class:`~crosscoder_tpu_torch.obs.registry.MetricsRegistry`
  when given one: ``perf/<name>_ms`` as an EMA of the span's duration and
  ``perf/<name>_spans`` as a count.

Library code records through the module-level :func:`span` and
:func:`instant`, which delegate to a process-global tracer, by default
:class:`NullTracer`: a span site then costs one global load and one call,
takes no lock and allocates nothing (the shared :data:`_NULL_SPAN`).
:class:`~crosscoder_tpu_torch.obs.Observability` installs a real tracer for
a run and restores the previous one on close.

Span names: ``step`` (a train step's launches), ``refill_wait`` (the loop
blocked on the next batch), ``harvest`` (one chunk landing in the store),
``refill`` (a refill cycle's completion), ``refill_dispatch`` (a pump of
the overlap's dispatcher), ``save`` / ``save_write`` / ``restore``
(checkpoint), ``watchdog_call`` (a watched serve), the serve engine's and
the fleet's own.
"""

from __future__ import annotations

import json
import os
import threading
import time
from pathlib import Path
from typing import Any


class _NullSpan:
    """Shared no-op context manager: the whole off-path cost of a span."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """The off-state tracer: every operation is a no-op."""

    enabled = False

    def span(self, name: str, /, **args: Any) -> _NullSpan:
        return _NULL_SPAN

    def instant(self, name: str, /, **args: Any) -> None:
        return None

    def flush(self) -> None:
        return None

    def close(self) -> None:
        return None


class _Span:
    """One live span: enters ``record_function(name)``, times the body and
    registers the event on exit."""

    __slots__ = ("_tracer", "_name", "_args", "_t0", "_ann")

    def __init__(self, tracer: "SpanTracer", name: str, args: dict[str, Any]):
        self._tracer = tracer
        self._name = name
        self._args = args
        self._ann = None

    def __enter__(self) -> "_Span":
        from torch.profiler import record_function

        self._ann = record_function(self._name)
        self._ann.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc: Any) -> bool:
        dur_ns = time.perf_counter_ns() - self._t0
        self._ann.__exit__(*exc)
        self._tracer._record(self._name, self._t0, dur_ns, self._args)
        return False


class SpanTracer:
    """Collects trace events in memory; :meth:`flush` and :meth:`close`
    write the Chrome trace-event JSON (``{"traceEvents": [...]}``).

    Thread-safe: spans open and close on any thread, each event carrying
    its thread's id, so Perfetto draws one track a thread.
    """

    enabled = True

    # events kept in memory (~300 B each, ~150 MB at the cap); past it new
    # events are dropped and counted, and the count is written into the
    # trace ("dropped_events"), so a truncated trace never reads as whole
    MAX_EVENTS = 500_000

    def __init__(self, path: str | Path, registry: Any | None = None,
                 process_name: str = "crosscoder_tpu_torch") -> None:
        self.path = Path(path)
        self.registry = registry
        self.dropped = 0
        self._lock = threading.Lock()
        self._epoch_ns = time.perf_counter_ns()
        self._pid = os.getpid()
        self._events: list[dict[str, Any]] = [{
            "name": "process_name", "ph": "M", "pid": self._pid, "tid": 0,
            "args": {"name": process_name},
        }]

    # -- recording ------------------------------------------------------
    def span(self, name: str, /, **args: Any) -> _Span:
        return _Span(self, name, args)

    def _append(self, ev: dict[str, Any]) -> None:
        with self._lock:
            if len(self._events) < self.MAX_EVENTS:
                self._events.append(ev)
            else:
                self.dropped += 1

    def instant(self, name: str, /, **args: Any) -> None:
        ev: dict[str, Any] = {
            "name": name, "ph": "i", "s": "t",
            "ts": (time.perf_counter_ns() - self._epoch_ns) / 1e3,
            "pid": self._pid, "tid": threading.get_ident() & 0xFFFFFFFF,
        }
        if args:
            ev["args"] = args
        self._append(ev)

    def _record(self, name: str, t0_ns: int, dur_ns: int, args: dict[str, Any]) -> None:
        ev: dict[str, Any] = {
            "name": name, "ph": "X", "cat": "host",
            "ts": (t0_ns - self._epoch_ns) / 1e3,
            "dur": dur_ns / 1e3,
            "pid": self._pid, "tid": threading.get_ident() & 0xFFFFFFFF,
        }
        if args:
            ev["args"] = args
        self._append(ev)
        if self.registry is not None:
            self.registry.ema(f"perf/{name}_ms", dur_ns / 1e6)
            self.registry.count(f"perf/{name}_spans")

    # -- inspection / output -------------------------------------------
    def events(self) -> list[dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def flush(self) -> Path:
        """Write everything recorded so far, atomically (a ``.tmp``
        sibling renamed over the file); safe to call again, the file always
        holds a whole trace."""
        with self._lock:
            payload: dict[str, Any] = {"traceEvents": list(self._events),
                                       "displayTimeUnit": "ms"}
            if self.dropped:
                payload["dropped_events"] = self.dropped
        self.path.parent.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_name(self.path.name + ".tmp")
        tmp.write_text(json.dumps(payload))
        os.replace(tmp, self.path)
        return self.path

    def close(self) -> None:
        self.flush()


# ---------------------------------------------------------------------------
# the process-global tracer (what library call sites use)

_TRACER: NullTracer | SpanTracer = NullTracer()


def get_tracer() -> NullTracer | SpanTracer:
    return _TRACER


def set_tracer(tracer: Any) -> Any:
    """Install ``tracer`` process-wide (any object with ``span(name,
    **args)`` returning a context manager and ``instant(name, **args)``);
    returns the one it replaces."""
    global _TRACER
    prev = _TRACER
    _TRACER = tracer
    return prev


def span(name: str, /, **args: Any):
    """Record a span on the process-global tracer (no-op by default)."""
    return _TRACER.span(name, **args)


def instant(name: str, /, **args: Any) -> None:
    """Record an instant event on the process-global tracer."""
    return _TRACER.instant(name, **args)
