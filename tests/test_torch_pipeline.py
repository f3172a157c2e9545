"""The port's pipelining helpers (crosscoder_tpu_torch/utils/pipeline.py):
the ticketed :class:`LaunchSequencer` with the cases of the JAX package's
tests/test_pipeline.py, and the refill's :class:`QuantumDispatcher`
(credit spent in the order posted, ``drain`` waits and re-raises, ``close``
is idempotent), with a stress case of many posting threads under a short
switch interval. Every join and wait has a timeout."""

import sys
import threading
import time

import pytest

from crosscoder_tpu_torch.utils import pipeline

T = 10.0          # seconds any wait in this file may take


def test_sequencer_executes_in_reservation_order():
    """Threads entering their turns in reverse order still run in the order
    of reservation."""
    seq = pipeline.LaunchSequencer()
    tickets = [seq.reserve() for _ in range(3)]
    order = []

    def run(ticket, delay):
        time.sleep(delay)
        with seq.turn(ticket):
            order.append(ticket)

    threads = [threading.Thread(target=run, args=(t, d))
               for t, d in zip(tickets, (0.06, 0.03, 0.0))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=T)
        assert not t.is_alive()
    assert order == tickets


def test_sequencer_skip_unblocks_later_turns():
    seq = pipeline.LaunchSequencer()
    a, b = seq.reserve(), seq.reserve()
    seq.skip(a)
    ran = []
    with seq.turn(b):
        ran.append(b)
    assert ran == [b]


def test_sequencer_releases_on_exception():
    """A launch that raises inside its turn still releases its slot."""
    seq = pipeline.LaunchSequencer()
    a, b = seq.reserve(), seq.reserve()
    with pytest.raises(RuntimeError, match="launch failed"):
        with seq.turn(a):
            raise RuntimeError("launch failed")
    done = []

    def later():
        with seq.turn(b):
            done.append(b)

    t = threading.Thread(target=later)
    t.start()
    t.join(timeout=T)
    assert not t.is_alive() and done == [b]


def test_sequencer_out_of_order_release():
    seq = pipeline.LaunchSequencer()
    a, b, c = seq.reserve(), seq.reserve(), seq.reserve()
    seq.skip(b)
    seq.skip(a)
    with seq.turn(c):
        pass


def test_sequencer_invalidate_releases_stale_tickets():
    seq = pipeline.LaunchSequencer()
    seq.reserve()                       # never released
    b = seq.reserve()
    started, done = threading.Event(), []

    def blocked():
        started.set()
        with seq.turn(b):
            done.append(b)

    t = threading.Thread(target=blocked)
    t.start()
    assert started.wait(timeout=T)
    time.sleep(0.05)
    assert done == []
    seq.invalidate()
    t.join(timeout=T)
    assert not t.is_alive() and done == [b]
    with seq.turn(seq.reserve()):       # later tickets pass straight through
        pass


def test_dispatcher_spends_credit_in_order_and_drains():
    """Credit posted while the pump is busy is spent by the next pump call,
    after the one running: the pump sees the credit in the order posted,
    every unit once."""
    gate = threading.Event()
    seen = []

    def pump(credit):
        seen.append(credit)
        if len(seen) == 1:
            assert gate.wait(timeout=T)

    d = pipeline.QuantumDispatcher(pump)
    try:
        d.submit(2)
        time.sleep(0.05)                # the thread is inside the first pump
        d.submit(3)
        d.submit(4)
        d.submit(0)                     # no credit, nothing posted
        gate.set()
        d.drain()
        assert seen == [2, 7]
        d.submit(1)
        d.drain()
        assert seen == [2, 7, 1]
    finally:
        d.close()


def test_dispatcher_drain_reraises_the_pump_error_once():
    calls = []

    def pump(credit):
        calls.append(credit)
        raise ValueError(f"harvest failed at {credit}")

    d = pipeline.QuantumDispatcher(pump)
    try:
        d.submit(5)
        with pytest.raises(ValueError, match="harvest failed at 5"):
            d.drain()
        d.drain()                       # reported once
        d.submit(1)
        with pytest.raises(ValueError, match="harvest failed at 1"):
            d.drain()
    finally:
        d.close()
    assert calls == [5, 1]


def test_dispatcher_close_is_idempotent_and_refuses_new_credit():
    spent = []
    d = pipeline.QuantumDispatcher(spent.append)
    d.submit(3)
    d.close()
    assert spent == [3]                 # posted credit is spent before the stop
    assert not d._thread.is_alive()
    d.close()
    with pytest.raises(RuntimeError, match="closed"):
        d.submit(1)


def test_dispatcher_close_swallows_a_pump_error():
    def pump(credit):
        raise RuntimeError("boom")

    d = pipeline.QuantumDispatcher(pump)
    d.submit(1)
    d.close()                           # teardown path: no raise
    d.drain()


def test_dispatcher_counts_every_credit_under_contention():
    """Eight threads post 200 credits each under a short switch interval;
    the pump's running total equals everything posted: no credit lost or
    spent twice."""
    total = [0]
    lock = threading.Lock()

    def pump(credit):
        with lock:
            total[0] += credit

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    d = pipeline.QuantumDispatcher(pump)
    try:
        def post():
            for _ in range(200):
                d.submit(1)

        threads = [threading.Thread(target=post) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=T)
            assert not t.is_alive()
        d.drain()
        assert total[0] == 8 * 200
    finally:
        sys.setswitchinterval(old)
        d.close()


def test_guard_and_finish_are_no_ops():
    with pipeline.sharded_program_guard():
        pipeline.finish_on_cpu([object()])
