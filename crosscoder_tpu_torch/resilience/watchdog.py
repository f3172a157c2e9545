"""Timeout and exponential-backoff retry around the data pipeline, ported
from :mod:`crosscoder_tpu.resilience.watchdog`.

A serve can hang (a wedged harvest, a stuck filesystem) or fail for a
moment. :class:`Watchdog` runs the call two ways, by how the fault shows:

- **an exception**: the call ended, so the pipeline is quiet again; call
  it again after ``backoff_s · 2^attempt``, up to ``retries`` times, then
  raise;
- **a stall**: the call may still run on its thread and will touch the
  pipeline's state when it wakes, so no second call starts beside it. The
  watchdog counts the stall (``<name>_timeouts``), doubles its wait and
  waits again; a stall that clears goes on unseen, one that does not
  spends the budget and raises :class:`WatchdogTimeout` rather than hang
  the run.

Every detection bumps a counter of
:class:`~crosscoder_tpu_torch.utils.logging.ResilienceCounters` and records
an instant (``watchdog_stall``, ``watchdog_retry``) beside the runner's
``watchdog_call`` span on the process-global tracer.

Each call runs on a new daemon thread, which enters the CUDA device and
stream that were current on the calling thread when :meth:`Watchdog.call`
began: a thread starts on its device's default stream, and a serve on the
prefetch worker must launch on the worker's stream, where the events that
order its copy before the step are recorded.

On more than one rank the trainer runs without the watchdog: a retry
launches a serve's collectives at a time of one rank's own.
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time
from typing import Any, Callable

import torch

from crosscoder_tpu_torch.obs import trace
from crosscoder_tpu_torch.utils.logging import ResilienceCounters


class WatchdogTimeout(TimeoutError):
    """A watched call stalled past the whole escalation budget."""


def _caller_cuda_stream():
    """The calling thread's current CUDA stream (it names its device), or
    ``None`` where no CUDA context was made."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        return torch.cuda.current_stream()
    return None


class Watchdog:
    def __init__(self, timeout_s: float, retries: int = 3, backoff_s: float = 0.5,
                 name: str = "harvest", counters: ResilienceCounters | None = None) -> None:
        if timeout_s <= 0:
            raise ValueError(f"timeout_s must be > 0, got {timeout_s}")
        self.timeout_s = timeout_s
        self.retries = retries
        self.backoff_s = backoff_s
        self.name = name
        self.counters = counters if counters is not None else ResilienceCounters()

    def call(self, fn: Callable[[], Any]) -> Any:
        """Run ``fn`` under watch: its result, or a raise once the retry
        and patience budget is spent. Each attempt runs on a new daemon
        thread (a pool's threads are joined at exit, so one call stalled
        for ever would hold the process)."""
        stream = _caller_cuda_stream()
        attempt = 0
        while True:
            outcome: dict[str, Any] = {}
            done = threading.Event()

            def runner() -> None:
                try:
                    with contextlib.ExitStack() as ctx:
                        if stream is not None:
                            ctx.enter_context(torch.cuda.device(stream.device))
                            ctx.enter_context(torch.cuda.stream(stream))
                        # a stalled call shows as one long span, the waiting
                        # thread's watchdog_stall instants beside it
                        ctx.enter_context(trace.span("watchdog_call", watched=self.name,
                                                     attempt=attempt))
                        outcome["value"] = fn()
                except BaseException as e:  # noqa: BLE001 — handed to the waiting thread
                    outcome["error"] = e
                finally:
                    done.set()

            threading.Thread(target=runner, name=f"watchdog-{self.name}", daemon=True).start()
            patience = self.timeout_s
            extensions = 0
            # done-ness apart from the outcome: an fn that raises
            # TimeoutError itself takes the retry path, not the stall path
            while not done.wait(timeout=patience):
                if extensions >= self.retries:
                    raise WatchdogTimeout(
                        f"{self.name} stalled: no result after {extensions + 1} waits (last "
                        f"{patience:.1f}s); aborting rather than hanging the run")
                extensions += 1
                self.counters.bump(f"{self.name}_timeouts")
                trace.instant("watchdog_stall", watched=self.name, waited_s=patience)
                print(f"[crosscoder_tpu_torch] watchdog: {self.name} stall #{extensions} "
                      f"(waited {patience:.1f}s); extending wait", file=sys.stderr, flush=True)
                patience *= 2
            err = outcome.get("error")
            if err is None:
                return outcome["value"]
            if attempt >= self.retries:
                raise err
            attempt += 1
            delay = self.backoff_s * 2 ** (attempt - 1)
            self.counters.bump(f"{self.name}_retries")
            trace.instant("watchdog_retry", watched=self.name, attempt=attempt,
                          error=type(err).__name__)
            print(f"[crosscoder_tpu_torch] watchdog: {self.name} failed "
                  f"({type(err).__name__}: {err}); retry {attempt}/{self.retries} in "
                  f"{delay:.2f}s", file=sys.stderr, flush=True)
            time.sleep(delay)

    def close(self) -> None:
        """Nothing to tear down: the runners are daemon threads."""
