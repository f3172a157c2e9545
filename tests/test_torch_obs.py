"""The port's telemetry plane (crosscoder_tpu_torch/obs: ``SpanTracer``,
``MetricsRegistry``, ``Observability``, ``ProfilerWindow`` on
``torch.profiler``) against the JAX package's (crosscoder_tpu/obs), on
the same programs and configs:

- the tracer: one span program (nesting, args, instants, eight threads)
  gives JAX's event list once ``ts``, ``dur``, ``pid`` and ``tid`` are
  removed, the same cap and drop count and the same ``perf/*`` registry
  keys; the port's ``trace.json`` is summarized by
  ``scripts/trace_report.py`` in a subprocess;
- ``parse_profile_steps`` gives JAX's result or message on a table of
  specs; the window opens and closes at JAX's steps on one program of
  hooks (exact window, SIGUSR1, stale window, legacy window), with
  ``torch.profiler`` and ``jax.profiler`` faked; the legacy window writes
  a real trace, and a window open at a rollback is closed;
- the plane in the trainer: obs on is bitwise obs off after 5 steps with
  no extra host read (``.item``, ``.cpu``, ``float()``, ...) or sync; the
  logged key set is JAX's but ``perf/compile*`` (nothing is compiled);
  ``perf/refill_bubble_frac`` matches a slowed source's ground truth
  (JAX's test, ±0.05); the spans cover the step, the wait, the save and
  the restore; the comm gauges on 2 gloo DP ranks are within 2% of JAX's
  ``_account_comm`` on 2 devices (one fork-server launch);
- the config's validation of the plane's and the watchdog's fields gives
  JAX's errors.
"""

import collections
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from crosscoder_tpu.config import CrossCoderConfig as JCfg
from crosscoder_tpu.obs import profiler as jprofiler
from crosscoder_tpu.obs.registry import MetricsRegistry as JRegistry
from crosscoder_tpu.obs.trace import SpanTracer as JSpanTracer
from crosscoder_tpu.parallel import mesh as jmesh
from crosscoder_tpu.train import trainer as jtrainer
from crosscoder_tpu.utils.logging import MetricsLogger as JLogger
from crosscoder_tpu_torch.checkpoint import Checkpointer
from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.data.synthetic import SyntheticActivationSource
from crosscoder_tpu_torch.obs import Observability, trace
from crosscoder_tpu_torch.obs import profiler as pprofiler
from crosscoder_tpu_torch.obs.registry import MetricsRegistry
from crosscoder_tpu_torch.obs.trace import NullTracer, SpanTracer
from crosscoder_tpu_torch.train.trainer import Trainer
from crosscoder_tpu_torch.utils.logging import MetricsLogger

from _torch_parallel_child import finish_ranks, start_ranks

ROOT = Path(__file__).resolve().parent.parent


def tiny_kw(**kw):
    base = dict(d_in=16, dict_size=64, batch_size=32, num_tokens=32 * 400, enc_dtype="fp32",
                lr=2e-3, l1_coeff=0.02, log_backend="null")
    base.update(kw)
    return base


# ---------------------------------------------------------------------------
# the tracer against JAX's


def _span_program(tracer):
    with tracer.span("outer", step=3):
        with tracer.span("inner"):
            time.sleep(0.001)
        tracer.instant("marker", note="x")
    barrier = threading.Barrier(8)

    def worker(i):
        barrier.wait()
        for _ in range(25):
            with tracer.span("w", thread=i):
                pass

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    tracer.instant("end")


def _strip(events):
    return [{k: v for k, v in e.items() if k not in ("ts", "dur", "pid", "tid")} for e in events]


def test_span_program_gives_jaxs_events_and_registry_keys(tmp_path):
    port, ref = MetricsRegistry(), JRegistry()
    got = SpanTracer(tmp_path / "p.json", registry=port)
    want = JSpanTracer(tmp_path / "j.json", registry=ref)
    _span_program(got)
    _span_program(want)
    g, w = _strip(got.events()), _strip(want.events())
    assert g[0]["args"] == {"name": "crosscoder_tpu_torch"} and w[0]["args"] == {
        "name": "crosscoder_tpu"}
    key = lambda e: json.dumps(e, sort_keys=True)  # noqa: E731 — the threads' order varies
    assert g[1:4] == w[1:4]                                  # inner, marker, outer, in order
    assert sorted(map(key, g[1:])) == sorted(map(key, w[1:]))
    assert len(g) == 1 + 3 + 200 + 1
    events = got.events()
    assert len({e["tid"] for e in events if e["name"] == "w"}) == 8
    inner, outer = events[1], events[3]
    assert inner["tid"] == outer["tid"] and outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-3
    snap, jsnap = port.snapshot(), ref.snapshot()
    assert snap.keys() == jsnap.keys() == {
        "perf/outer_ms", "perf/outer_spans", "perf/inner_ms", "perf/inner_spans", "perf/w_ms",
        "perf/w_spans"}
    assert snap["perf/w_spans"] == jsnap["perf/w_spans"] == 200
    data = json.loads(got.flush().read_text())
    assert data["displayTimeUnit"] == "ms" and "dropped_events" not in data


def test_cap_and_drop_count_as_jax(tmp_path):
    out = []
    for cls in (SpanTracer, JSpanTracer):
        t = cls(tmp_path / f"{cls.__module__}.json")
        t.MAX_EVENTS = 10
        for _ in range(20):
            with t.span("s"):
                pass
        t.instant("late")
        data = json.loads(t.flush().read_text())
        out.append((len(data["traceEvents"]), data["dropped_events"], t.dropped))
    assert out[0] == out[1] == (10, 12, 12)


def test_null_tracer_is_one_shared_no_op_and_the_default():
    assert isinstance(trace.get_tracer(), NullTracer)
    t = NullTracer()
    s = t.span("anything", k=1)
    assert s is trace._NULL_SPAN and t.span("other") is s
    with s:
        pass
    assert t.instant("x") is None and t.flush() is None and t.close() is None
    with trace.span("free"):
        trace.instant("free")


def test_span_enters_record_function(tmp_path, monkeypatch):
    """A real span opens ``torch.profiler.record_function(name)``; the null
    tracer never does."""
    seen = []
    import torch.profiler as tprof

    real = tprof.record_function

    def spy(name, *a, **k):
        seen.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(tprof, "record_function", spy)
    with SpanTracer(tmp_path / "t.json").span("step"):
        pass
    with NullTracer().span("step"):
        pass
    assert seen == ["step"]


def test_trace_report_summarizes_the_ports_trace(tmp_path):
    t = SpanTracer(tmp_path / "trace.json")
    for _ in range(4):
        with t.span("step"):
            time.sleep(0.001)
    with t.span("refill_wait"):
        time.sleep(0.004)
    t.close()
    r = subprocess.run([sys.executable, str(ROOT / "scripts" / "trace_report.py"),
                        str(tmp_path / "trace.json")], capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    assert "step" in r.stdout and "refill_wait" in r.stdout and "refill_bubble_frac" in r.stdout


def test_registry_shapes_and_untouched_snapshot():
    for cls in (MetricsRegistry, JRegistry):
        assert cls().snapshot() == {}
    snaps = []
    for cls in (MetricsRegistry, JRegistry):
        r = cls()
        r.count("perf/things")
        r.count("perf/things", 2)
        r.count("perf/zero", 0)
        r.gauge("perf/level", 0.5)
        r.ema("perf/lat_ms", 10.0)
        r.ema("perf/lat_ms", 20.0)
        for v in [1.0, 2.0, 3.0, 100.0]:
            r.observe("perf/hist", v)
        assert r.get_gauge("perf/level") == 0.5 and r.get_count("perf/things") == 3
        snaps.append(r.snapshot())
    assert snaps[0] == snaps[1]
    assert snaps[0]["perf/lat_ms"] == pytest.approx(11.0)


# ---------------------------------------------------------------------------
# profile windows

PROFILE_SPECS = ["", "3:7", "0:1", "48190:48200", "3", "7:3", "3:3", "a:b", "-1:4", "1:2:3",
                 " 2:5", "2: 5", ":", "1:"]


@pytest.mark.parametrize("spec", PROFILE_SPECS)
def test_parse_profile_steps_as_jax(spec):
    try:
        want = ("ok", jprofiler.parse_profile_steps(spec))
    except ValueError as e:
        want = ("error", str(e))
    try:
        got = ("ok", pprofiler.parse_profile_steps(spec))
    except ValueError as e:
        got = ("error", str(e))
    assert got == want


class FakeProfile:
    """Stands in for ``torch.profiler.profile``: records its lifetime."""

    log: list = []

    def __init__(self, activities):
        FakeProfile.log.append(("new", tuple(a.name for a in activities)))

    def start(self):
        FakeProfile.log.append("start")

    def stop(self):
        FakeProfile.log.append("stop")

    def export_chrome_trace(self, path):
        Path(path).write_text('{"traceEvents": []}')
        FakeProfile.log.append(("export", Path(path).name))


@pytest.fixture
def fake_profilers(monkeypatch):
    """Both packages' profilers faked: ``log[side]`` lists each start and
    stop with the step the hooks were at."""
    import torch.profiler as tprof

    FakeProfile.log = []
    monkeypatch.setattr(tprof, "profile", FakeProfile)
    jlog = []
    monkeypatch.setattr(jax.profiler, "start_trace", lambda d: jlog.append("start"))
    monkeypatch.setattr(jax.profiler, "stop_trace", lambda: jlog.append("stop"))
    return jlog


def _drive(pw, log, program):
    """Run a program of hook calls; each start or stop the hooks made,
    with the step at which they made it."""
    seen, at = [], 0
    for op, *args in program:
        n = len(log)
        if op == "stretch":
            pw.begin_stretch(*args)
        elif op == "step":
            pw.before_step(args[0])
            at = args[0]
            for e in log[n:]:
                if e in ("start", "stop"):
                    seen.append((e, at))
            n = len(log)
            pw.after_step(args[0])
        elif op == "request":
            pw.request_window(*args)
        elif op == "stop_if_active":
            pw.stop_if_active()
        for e in log[n:]:
            if e in ("start", "stop"):
                seen.append((e, at))
    return seen


WINDOW_PROGRAMS = {
    "exact": (dict(profile_steps="2:4"), [("stretch", 0)] + [("step", i) for i in range(6)]),
    "sigusr1": (dict(obs="on"), [("stretch", 0), ("step", 0), ("request", 2), ("step", 1),
                                 ("step", 2), ("step", 3), ("step", 4)]),
    "stale": (dict(profile_steps="2:4"), [("stretch", 100), ("step", 100), ("request", 1),
                                          ("step", 101), ("step", 102)]),
    "legacy": (dict(profile_dir="P"), [("stretch", 3)] + [("step", i) for i in range(3, 20)]),
    "rollback": (dict(profile_dir="P"), [("stretch", 0)] + [("step", i) for i in range(13)]
                 + [("stop_if_active",), ("stretch", 5)] + [("step", i) for i in range(5, 22)]),
    "pending_first": (dict(profile_steps="3:5"), [("stretch", 0), ("request", 2)]
                      + [("step", i) for i in range(9)]),
}


@pytest.mark.parametrize("name", sorted(WINDOW_PROGRAMS))
def test_window_opens_and_closes_at_jaxs_steps(tmp_path, fake_profilers, name):
    kw, program = WINDOW_PROGRAMS[name]
    if "profile_dir" in kw:
        kw = dict(kw, profile_dir=str(tmp_path / "prof"))
    cfg = CrossCoderConfig(**tiny_kw(checkpoint_dir=str(tmp_path), **kw))
    jcfg = JCfg(**tiny_kw(checkpoint_dir=str(tmp_path), **kw))
    pw = pprofiler.ProfilerWindow(cfg, registry=MetricsRegistry())
    jpw = jprofiler.ProfilerWindow(jcfg)
    got = _drive(pw, FakeProfile.log, program)
    want = _drive(jpw, fake_profilers, program)
    assert got == want and got, got
    assert pw.windows_captured == jpw.windows_captured
    exports = [e[1] for e in FakeProfile.log if isinstance(e, tuple) and e[0] == "export"]
    assert len(exports) == pw.windows_captured and all(p.exists() for p in pw.paths)
    assert ("new", ("CPU",)) in FakeProfile.log           # no CUDA activity on a CPU device
    assert pw.registry.snapshot() == {"perf/profile_windows": pw.windows_captured}
    if name == "exact":
        assert got == [("start", 2), ("stop", 3)]
        assert exports == ["window0_steps_2-3.trace.json"]
        assert pw.out_dir == str(tmp_path / "obs" / "profile")


def test_sigusr1_arms_a_window_in_the_main_thread(tmp_path, fake_profilers):
    import os
    import signal

    pw = pprofiler.ProfilerWindow(CrossCoderConfig(**tiny_kw(checkpoint_dir=str(tmp_path))))
    assert not pw.configured
    prev = signal.getsignal(signal.SIGUSR1)
    assert pw.install_sigusr1()
    try:
        os.kill(os.getpid(), signal.SIGUSR1)
        time.sleep(0.05)
        for i in range(7):
            pw.before_step(i)
            pw.after_step(i)
    finally:
        pw.uninstall_sigusr1()
    assert signal.getsignal(signal.SIGUSR1) is prev
    assert pw.windows_captured == 1 and pw.paths[0].name == "window0_steps_0-4.trace.json"
    out = []
    t = threading.Thread(target=lambda: out.append(pw.install_sigusr1()))
    t.start()
    t.join()
    assert out == [False]


def test_trainer_captures_the_configured_steps(tmp_path, fake_profilers):
    cfg = CrossCoderConfig(**tiny_kw(profile_steps="2:4", obs="on", num_tokens=32 * 30,
                                     checkpoint_dir=str(tmp_path), save_every=10 ** 9))
    Trainer(cfg, device="cpu").train(num_steps=6)
    assert FakeProfile.log.count("start") == 1 and FakeProfile.log.count("stop") == 1
    assert (tmp_path / "obs" / "profile" / "window0_steps_2-3.trace.json").exists()


def test_legacy_profile_dir_window_writes_a_real_trace(tmp_path):
    """``profile_dir`` alone: the steps 10-14 window through the real
    ``torch.profiler`` (the CPU activity here), one Chrome trace on disk
    holding the step's operators; no memory gauge on the CPU."""
    cfg = CrossCoderConfig(**tiny_kw(profile_dir=str(tmp_path / "prof"), num_tokens=32 * 30,
                                     checkpoint_dir=str(tmp_path), save_every=10 ** 9,
                                     obs="on", log_every=15, log_backend="jsonl"))
    Trainer(cfg, device="cpu", logger=MetricsLogger(cfg)).train(num_steps=16)
    files = sorted((tmp_path / "prof").iterdir())
    assert [f.name for f in files] == ["window0_steps_10-14.trace.json"]
    names = {e.get("name") for e in json.loads(files[0].read_text())["traceEvents"]}
    assert "step" in names and "refill_wait" in names and "aten::mm" in names
    rec = json.loads((tmp_path / "metrics.jsonl").read_text().splitlines()[-1])
    assert rec["perf/profile_windows"] == 1
    assert not any(k.startswith("perf/hbm_") for k in rec)


# ---------------------------------------------------------------------------
# the plane in the trainer


HOST_READS = ("item", "cpu", "tolist", "numpy", "__float__", "__int__", "__bool__")


def _counting_host_reads(monkeypatch):
    counts = collections.Counter()
    for name in HOST_READS:
        real = getattr(torch.Tensor, name)

        def spy(self, *a, _real=real, _name=name, **k):
            counts[_name] += 1
            return _real(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, spy)
    real_sync = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: (counts.update(["synchronize"]), real_sync(*a, **k))[1])
    return counts


@pytest.mark.parametrize("prefetch", [False, True], ids=["inline", "prefetch"])
def test_obs_on_is_bitwise_obs_off_and_adds_no_host_read(tmp_path, monkeypatch, prefetch):
    runs = {}
    for obs in ("off", "on"):
        cfg = CrossCoderConfig(**tiny_kw(obs=obs, prefetch=prefetch, activation="topk",
                                         topk_k=4, l1_coeff=0.0, sparse_bwd="on", aux_k=8,
                                         aux_every=2, aux_dead_steps=2,
                                         checkpoint_dir=str(tmp_path / obs)))
        tr = Trainer(cfg, device="cpu")
        with monkeypatch.context() as m:
            counts = _counting_host_reads(m)
            metrics = [tr.step(full_metrics=False) for _ in range(5)]
            tr._drain_prefetch()
        counts = dict(counts)
        losses = [m["loss"] for m in metrics]
        tr.close()
        runs[obs] = (tr.state, losses, counts)
    (s0, l0, c0), (s1, l1, c1) = runs["off"], runs["on"]
    assert c1 == c0, (c0, c1)
    for a, b in zip(l0, l1):
        assert torch.equal(a, b)
    for x, y in ((s0.params, s1.params), (s0.opt_state.mu, s1.opt_state.mu),
                 (s0.opt_state.nu, s1.opt_state.nu), (s0.aux, s1.aux)):
        for k in x:
            assert torch.equal(x[k], y[k]), k
    assert s0.step == s1.step == 5
    data = json.loads((tmp_path / "on" / "obs" / "trace.json").read_text())
    names = collections.Counter(e["name"] for e in data["traceEvents"] if e["ph"] == "X")
    assert names["step"] == names["refill_wait"] == 5
    assert isinstance(trace.get_tracer(), NullTracer)


COMPILE = "perf/compile"


def test_logged_keys_are_jaxs_but_the_compile_events(tmp_path):
    keys = {}
    for side, Cfg, Tr, Lg, kw in (
            ("jax", JCfg, jtrainer.Trainer, JLogger,
             dict(mesh=jmesh.make_mesh(devices=jax.devices()[:1]))),
            ("port", CrossCoderConfig, Trainer, MetricsLogger, dict(device="cpu"))):
        cfg = Cfg(**tiny_kw(log_every=2, save_every=3, checkpoint_dir=str(tmp_path / side),
                            log_backend="jsonl", obs="on", num_tokens=32 * 30,
                            profile_steps="1:2", prefetch=False))
        tr = Tr(cfg, logger=Lg(cfg), **kw)
        tr.train(num_steps=5)
        lines = [json.loads(x) for x in
                 (tmp_path / side / "metrics.jsonl").read_text().splitlines()]
        keys[side] = set().union(*lines)
        if side == "port":
            rec = lines[-1]
    jax_keys = {k for k in keys["jax"] if not k.startswith(COMPILE)}
    assert keys["jax"] - jax_keys, "JAX logged no compile event"
    assert keys["port"] == jax_keys, (keys["port"] ^ jax_keys)
    assert rec["perf/step_ms"] > 0 and rec["comm/h2d_transfers"] >= 5
    assert rec["comm/d2h_transfers"] == 3 and rec["comm/predicted_wire_bytes"] == 0.0
    assert rec["perf/profile_windows"] == 1


class SleepySource:
    """A source whose ``next()`` sleeps a fixed time and costs ~nothing
    else (one batch, served again): the slowed refill of JAX's test, whose
    ground truth is the slept share of the log interval."""

    def __init__(self, cfg, sleep_s):
        self._batch = SyntheticActivationSource(cfg).next()
        self.sleep_s = sleep_s
        self.slept = 0.0

    def next(self):
        t0 = time.perf_counter()
        time.sleep(self.sleep_s)
        self.slept += time.perf_counter() - t0
        return self._batch


def test_refill_bubble_frac_matches_ground_truth(tmp_path):
    cfg = CrossCoderConfig(**tiny_kw(log_every=8, save_every=10 ** 9,
                                     checkpoint_dir=str(tmp_path), log_backend="jsonl",
                                     obs="on", prefetch=False, num_tokens=32 * 30))
    src = SleepySource(cfg, sleep_s=0.06)
    tr = Trainer(cfg, src, device="cpu", logger=MetricsLogger(cfg))
    slept_at = []
    real_log = tr.log

    def spy_log(metrics, step):
        slept_at.append(src.slept)
        real_log(metrics, step)

    tr.log = spy_log
    tr.train(num_steps=17)              # logs at 0, 8, 16
    rec = json.loads((tmp_path / "metrics.jsonl").read_text().splitlines()[-1])
    frac = rec["perf/refill_bubble_frac"]
    wall_s = rec["step_time_ms"] * 8 / 1000
    truth = (slept_at[-1] - slept_at[-2]) / wall_s
    assert frac == pytest.approx(min(1.0, truth), abs=0.05), (frac, truth)
    assert rec["perf/step_wall_ms"] == rec["step_time_ms"]


def test_spans_cover_save_and_restore_and_the_tracer_is_given_back(tmp_path):
    cfg = CrossCoderConfig(**tiny_kw(checkpoint_dir=str(tmp_path), obs="on",
                                     num_tokens=32 * 30, save_every=10 ** 9))
    prev = trace.get_tracer()
    tr = Trainer(cfg, device="cpu", checkpointer=Checkpointer(cfg=cfg))
    assert isinstance(trace.get_tracer(), SpanTracer)
    tr.step()
    tr.save()
    tr.restore()
    tr.close()
    tr.close()
    assert trace.get_tracer() is prev
    data = json.loads((tmp_path / "obs" / "trace.json").read_text())
    names = {e["name"] for e in data["traceEvents"] if e["ph"] == "X"}
    assert {"save", "save_write", "restore", "step", "refill_wait"} <= names
    other = CrossCoderConfig(**tiny_kw(checkpoint_dir=str(tmp_path), obs="on",
                                       obs_dir=str(tmp_path / "elsewhere")))
    assert Observability(other).out_dir == str(tmp_path / "elsewhere")
    trace.set_tracer(prev)


def test_comm_gauges_on_two_gloo_ranks_within_2pct_of_jax(tmp_path):
    shape = dict(dict_size=256, d_in=32, batch_size=64)
    started = start_ranks(2, {"kind": "obs", "shape": shape}, tmp_path / "ranks")
    jcfg = JCfg(d_in=32, dict_size=256, n_models=2, batch_size=64, enc_dtype="bf16",
                master_dtype="bf16", log_backend="null", prefetch=False, data_axis_size=2,
                obs="on", checkpoint_dir=str(tmp_path / "j"))
    jtr = jtrainer.Trainer(jcfg, mesh=jmesh.make_mesh(devices=jax.devices()[:2]))
    jtr.step(full_metrics=False)
    want = jtr._obs.registry.snapshot()
    jtr.close()
    ranks = finish_ranks(started)
    for r, res in enumerate(ranks):
        got = res["comm"]
        for k in ("comm/predicted_wire_bytes", "comm/collective_output_bytes"):
            assert want[k] > 0 and abs(got[k] - want[k]) <= 0.02 * want[k], (k, got, want)
        assert got["comm/collectives_per_step"] > 0
        assert res["watchdog"] is False
    assert sorted(p.name for p in Path(ranks[0]["obs_dir"]).iterdir()) == [
        "trace.json", "trace.p1.json"]


# ---------------------------------------------------------------------------
# the config


@pytest.mark.parametrize("kw", [dict(obs="verbose"), dict(log_print_every=-1),
                                dict(profile_steps="10"), dict(profile_steps="7:3"),
                                dict(harvest_timeout_s=-1.0), dict(harvest_retries=-1),
                                dict(harvest_backoff_s=-0.5), dict(loss_spike_factor=1.0),
                                dict(guard_loss=True, keep_saves=1)])
def test_config_validation_gives_jaxs_errors(kw):
    with pytest.raises(ValueError) as want:
        JCfg(**tiny_kw(**kw))
    with pytest.raises(ValueError) as got:
        CrossCoderConfig(**tiny_kw(**kw))
    assert str(got.value) == str(want.value)


def test_valid_plane_fields_construct():
    CrossCoderConfig(**tiny_kw(obs="on", profile_steps="3:9", harvest_timeout_s=2.0,
                               chaos="nan@3"))
