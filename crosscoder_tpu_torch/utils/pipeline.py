"""Pipelining helpers for device→host streaming loops, ported from
:mod:`crosscoder_tpu.utils.pipeline`: the bounded in-flight window
(``drive``, ``DEFAULT_DEPTH``), the ticketed launch order across threads
(:class:`LaunchSequencer`) and the refill's dispatcher thread
(:class:`QuantumDispatcher`).

In PyTorch "in flight" means work queued on the stream before the host
reads a result back: a producer that dispatches a chunk's kernels and
returns device tensors lets the card run ahead while the host drains an
earlier chunk, and the bounded window keeps queued intermediates from
piling up.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Iterable, TypeVar

T = TypeVar("T")

# chunks kept in flight: device compute overlaps the host's reads of
# earlier chunks (1 = fully serial)
DEFAULT_DEPTH = 3


def drive(produced: Iterable[T], drain: Callable[[T], None], depth: int = DEFAULT_DEPTH) -> None:
    """Consume ``produced`` (an iterator that dispatches device work as it
    advances) keeping at most ``depth`` items in flight, calling ``drain``
    on each in FIFO order."""
    inflight: list[T] = []
    for item in produced:
        inflight.append(item)
        if len(inflight) >= depth:
            drain(inflight.pop(0))
    for item in inflight:
        drain(item)


def sharded_program_guard():
    """A null context. The JAX package serializes programs with
    collectives on XLA:CPU, where two running at once on the same host
    devices can deadlock in their rendezvous; the port runs one device a
    process, and a refill whose harvest or store issues collectives runs
    on the serving thread alone (no dispatcher thread), so there is
    nothing to serialize. Kept so that the buffer reads as the JAX one."""
    return contextlib.nullcontext()


def finish_on_cpu(tensors) -> None:
    """Nothing to do: the JAX package blocks on XLA:CPU results before it
    leaves :func:`sharded_program_guard`; eager PyTorch on the CPU has
    finished an op when the call returns, and on the card the queue stays
    asynchronous."""
    del tensors


class LaunchSequencer:
    """Ticketed launch ordering across threads: each launch site calls
    :meth:`reserve` on the deciding thread, in program order, and runs its
    launches under :meth:`turn`, which waits until every earlier ticket has
    been released. The order of reservation is then the order of launch,
    whichever thread runs each launch and whenever it is scheduled."""

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._next = 0              # next ticket to hand out
        self._head = 0              # lowest ticket not yet released
        self._released: set[int] = set()
        self._invalid = False

    def reserve(self) -> int:
        """Claim the next launch slot."""
        with self._cond:
            ticket = self._next
            self._next += 1
            return ticket

    @contextlib.contextmanager
    def turn(self, ticket: int):
        """Run under ``ticket``: entry waits for every earlier ticket's
        release; exit releases this one, also on an exception, so a failed
        launch never wedges the sequence."""
        with self._cond:
            while not self._invalid and self._head != ticket:
                self._cond.wait()
        try:
            yield
        finally:
            self.skip(ticket)

    def skip(self, ticket: int) -> None:
        """Release ``ticket`` without running anything under it."""
        with self._cond:
            self._released.add(ticket)
            while self._head in self._released:
                self._released.remove(self._head)
                self._head += 1
            self._cond.notify_all()

    def invalidate(self) -> None:
        """Retire the sequence: every outstanding and later ticket passes
        straight through :meth:`turn`."""
        with self._cond:
            self._invalid = True
            self._cond.notify_all()


class QuantumDispatcher:
    """A daemon thread that runs the refill's harvest dispatches off the
    serving thread: :meth:`submit` posts credit (the harvest quanta the
    pacing allows) and returns at once; the thread spends all credit
    posted so far in one ``pump(credit)`` call at a time.

    :meth:`drain` waits until every posted credit is spent and the pump is
    idle, then re-raises the first error the pump hit (later credit is
    dropped once one has, so the buffer's state stops where it failed).
    :meth:`close` stops the thread; it is idempotent and swallows a pump
    error, as it runs in teardown paths."""

    def __init__(self, pump: Callable[[int], None], name: str = "refill-dispatch") -> None:
        self._pump = pump
        self._cond = threading.Condition()
        self._credit = 0
        self._busy = False
        self._closed = False
        self._error: BaseException | None = None
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._credit and not self._closed:
                    self._cond.wait()
                if self._closed and not self._credit:
                    return
                credit, self._credit = self._credit, 0
                self._busy = True
            try:
                if self._error is None:
                    self._pump(credit)
            except BaseException as e:  # noqa: BLE001 — re-raised by drain()
                with self._cond:
                    self._error = e
            finally:
                with self._cond:
                    self._busy = False
                    self._cond.notify_all()

    def submit(self, credit: int) -> None:
        """Post ``credit`` dispatch quanta; returns immediately."""
        if credit <= 0:
            return
        with self._cond:
            if self._closed:
                raise RuntimeError("QuantumDispatcher is closed")
            self._credit += credit
            self._cond.notify_all()

    def drain(self) -> None:
        """Wait until idle; re-raise the pump's error, if any."""
        with self._cond:
            while self._credit or self._busy:
                self._cond.wait()
            if self._error is not None:
                err, self._error = self._error, None
                raise err

    def close(self) -> None:
        """Spend what is posted, then stop the thread."""
        with self._cond:
            if self._closed and not self._thread.is_alive():
                return
            self._closed = True
            self._cond.notify_all()
        self._thread.join()
        with self._cond:
            self._error = None
