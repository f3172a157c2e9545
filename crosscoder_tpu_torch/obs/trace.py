"""Host-side span hooks, ported from :mod:`crosscoder_tpu.obs.trace` as far
as the serve engine uses them: :func:`span` and :func:`instant`.

Both delegate to a process-global tracer that defaults to
:class:`NullTracer`, whose span is one shared no-op context manager. A
caller that wants events installs its own tracer (any object with
``span(name, **args)`` returning a context manager and
``instant(name, **args)``) with :func:`set_tracer`.
"""

from __future__ import annotations

from typing import Any


class _NullSpan:
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


_TRACER: Any = NullTracer()


def set_tracer(tracer: Any) -> Any:
    """Install ``tracer`` process-wide; returns the one it replaces."""
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
