"""The port's resilience hooks (crosscoder_tpu_torch/resilience: ``Chaos``,
``Watchdog``; the Checkpointer's ``counters`` and ``chaos``; the buffer's
``on_harvest``; the trainer's serve hooks) against the JAX package's
(crosscoder_tpu/resilience, its Checkpointer, buffer and Trainer), on the
same specs and inputs:

- the grammar: ``render(parse(s))`` is JAX's string for every spec of
  tests/test_resilience.py and the elastic ones; the same errors; the flaky
  miss pattern and the ``corrupt_save`` bytes are JAX's for the same seed;
- the watchdog's retry and stall escalation (JAX's tests), and its events
  on a tracer equal to JAX's once times and ids are removed;
- the Checkpointer's corrupt-save skip counted on the trainer's counters as
  JAX counts it (a fault of the port until this slice: it had no counters);
- the trainer: faults through the watchdog bitwise the clean run, the
  ``resilience/*`` snapshots of ``nan@`` under the guard, the corrupt save
  and JAX's integration run equal to JAX's;
- the buffer: a ``fail-harvest@`` fault raises where JAX's raises and a
  retried serve serves JAX's stream byte for byte, the refill overlap's
  dispatcher thread included (the harvest stubbed, as in
  tests/test_torch_buffer.py, through the real ``_harvest_job`` of the
  paged runtime, where the hook lives).

Stalls are 0.2 s against a 0.1 s timeout: one extension, 0.1 s of margin
either way."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crosscoder_tpu.checkpoint import Checkpointer as JCheckpointer
from crosscoder_tpu.config import CrossCoderConfig as JCfg
from crosscoder_tpu.data import buffer as jbuf
from crosscoder_tpu.obs.trace import SpanTracer as JSpanTracer
from crosscoder_tpu.obs import trace as jtrace
from crosscoder_tpu.parallel import mesh as jmesh
from crosscoder_tpu.resilience.chaos import Chaos as JChaos
from crosscoder_tpu.resilience.watchdog import Watchdog as JWatchdog
from crosscoder_tpu.train import trainer as jtrainer
from crosscoder_tpu.utils.logging import ResilienceCounters as JCounters
from crosscoder_tpu_torch import convert
from crosscoder_tpu_torch.checkpoint import Checkpointer
from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.data import buffer as buf
from crosscoder_tpu_torch.obs import trace
from crosscoder_tpu_torch.obs.trace import SpanTracer
from crosscoder_tpu_torch.resilience import Chaos, ChaosFault, Watchdog, WatchdogTimeout
from crosscoder_tpu_torch.train import trainer
from crosscoder_tpu_torch.utils.logging import ResilienceCounters

SPECS = [
    "nan@5,inf@7,stall@3:1.5,fail@4,stall-harvest@2,fail-harvest@9,corrupt-save@1:state,"
    "mode=flipbyte,seed=7",
    "nan@2,fail@3", "corrupt-save@1:state", "corrupt-save@0", "nan@11", "nan@9,nan@25",
    "stall@3:0.25", "fail@2", "stall@3:0.35,nan@11,corrupt-save@2:state",
    "die@3,return@5,flaky@2:0.3,slow@4:250,preempt@6,seed=3",
    " flaky@0 , slow@1 ,stall-harvest@4:0.5,corrupt-save@3:meta,corrupt-save@2:cfg",
]
BAD_SPECS = ["explode@3", "corrupt-save@0:nonsense", "nan", "flaky@1:1.5", "slow@2:0",
             "mode=shred"]


# ---------------------------------------------------------------------------
# the grammar


@pytest.mark.parametrize("spec", SPECS)
def test_render_of_parse_is_jaxs_string(spec):
    got, want = Chaos.parse(spec), JChaos.parse(spec)
    assert got.render() == want.render()
    assert Chaos.parse(got.render()).render() == got.render()
    for f in ("nan_serves", "inf_serves", "stall_serves", "fail_serves", "preempt_serves",
              "die_serves", "return_serves", "flaky_probes", "slow_probes", "stall_harvests",
              "fail_harvests", "corrupt_saves", "corrupt_mode", "seed"):
        assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_bad_specs_raise_jaxs_error(spec):
    with pytest.raises(ValueError) as want:
        JChaos.parse(spec)
    with pytest.raises(ValueError) as got:
        Chaos.parse(spec)
    assert str(got.value) == str(want.value)


def test_empty_spec_and_env(monkeypatch):
    assert Chaos.parse("") is None and Chaos.parse(None) is None and Chaos.parse("  ") is None
    monkeypatch.setenv("CROSSCODER_CHAOS", "nan@4,seed=2")
    assert Chaos.from_cfg_env(CrossCoderConfig()).render() == "nan@4,seed=2"
    assert Chaos.from_cfg_env(CrossCoderConfig(chaos="fail@1")).render() == "fail@1"
    monkeypatch.delenv("CROSSCODER_CHAOS")
    assert Chaos.from_cfg_env(CrossCoderConfig()) is None


@pytest.mark.parametrize("seed", [0, 7])
def test_flaky_and_slow_probes_answer_as_jax(seed):
    spec = f"flaky@3:0.4,flaky@20:0.9,slow@5:250,slow@9:40,seed={seed}"
    got, want = Chaos.parse(spec), JChaos.parse(spec)
    seq = [got.on_probe(i) for i in range(48)] + [got.on_probe(5)]
    assert seq == [want.on_probe(i) for i in range(48)] + [want.on_probe(5)]
    assert "skip" in seq and 0.25 in seq
    assert got.take_return(3) is False


@pytest.mark.parametrize("mode", ["truncate", "flipbyte"])
@pytest.mark.parametrize("kind", ["weights", "state", "cfg", "meta"])
def test_corrupt_save_writes_jaxs_bytes(tmp_path, mode, kind):
    spec = f"corrupt-save@3:{kind},mode={mode},seed=11"
    names = {"weights": "3.npz", "state": "3_train_state.npz", "cfg": "3_cfg.json",
             "meta": "3_meta.json"}
    blob = np.random.default_rng(5).integers(0, 256, size=4099, dtype=np.uint8).tobytes()
    for side in ("port", "jax"):
        (tmp_path / side).mkdir()
        for n in names.values():
            (tmp_path / side / n).write_bytes(blob)
    Chaos.parse(spec).corrupt_save(tmp_path / "port", 3)
    JChaos.parse(spec).corrupt_save(tmp_path / "jax", 3)
    for n in names.values():
        assert (tmp_path / "port" / n).read_bytes() == (tmp_path / "jax" / n).read_bytes(), n
    assert (tmp_path / "port" / names[kind]).read_bytes() != blob


def test_faults_fire_exactly_once_on_arrays_and_tensors():
    c = Chaos.parse("nan@2,inf@4,fail@3")
    b = np.ones((4, 2, 8), np.float32)
    assert np.isnan(c.poison_batch(b, 2)[0]).all() and np.isfinite(b).all()
    assert np.isfinite(c.poison_batch(b, 2)).all()          # fired: clean
    with pytest.raises(ChaosFault):
        c.on_serve(3)
    c.on_serve(3)                                            # fired: a no-op
    t = torch.ones(4, 2, 8, dtype=torch.bfloat16)
    out = c.poison_batch(t, 4)
    assert torch.isinf(out[0]).all() and torch.isfinite(out[1:]).all()
    assert torch.isfinite(t).all()                           # a copy, never the input
    staged = torch.ones(4, 2, 8)
    c2 = Chaos.parse("nan@0")
    assert c2.poison_batch(staged, 0, inplace=True) is staged and torch.isnan(staged[0]).all()


def test_on_harvest_counts_chunks_as_jax():
    spec = "stall-harvest@1:0.05,fail-harvest@3,fail-harvest@4"
    got, want = Chaos.parse(spec), JChaos.parse(spec)

    def run(c):
        out = []
        for _ in range(7):
            try:
                c.on_harvest()
                out.append("ok")
            except Exception as e:           # noqa: BLE001 — the outcome is compared
                out.append(type(e).__name__)
        return out

    assert run(got) == run(want) == ["ok", "ok", "ok", "ChaosFault", "ChaosFault", "ok", "ok"]


# ---------------------------------------------------------------------------
# the watchdog (JAX's tests, and its events on a tracer)


def test_watchdog_exception_backoff_retry():
    counters = ResilienceCounters()
    w = Watchdog(5.0, retries=2, backoff_s=0.01, counters=counters)
    calls = [0]

    def flaky():
        calls[0] += 1
        if calls[0] < 3:
            raise RuntimeError("transient")
        return "ok"

    assert w.call(flaky) == "ok"
    assert counters.get("harvest_retries") == 2
    with pytest.raises(RuntimeError, match="always"):
        w.call(lambda: (_ for _ in ()).throw(RuntimeError("always")))
    with pytest.raises(ValueError, match="timeout_s"):
        Watchdog(0.0)


def test_watchdog_stall_escalates_then_aborts():
    import time

    counters = ResilienceCounters()
    w = Watchdog(0.05, retries=1, backoff_s=0.01, counters=counters)
    assert w.call(lambda: (time.sleep(0.08), "late")[1]) == "late"
    assert counters.get("harvest_timeouts") >= 1
    with pytest.raises(WatchdogTimeout):
        w.call(lambda: time.sleep(30))


def _strip(events):
    return [{k: v for k, v in e.items() if k not in ("ts", "dur", "pid", "tid")}
            for e in events if e["ph"] != "M"]


def test_watchdog_events_equal_jaxs(tmp_path, monkeypatch):
    import time

    def program(w):
        calls = [0]

        def flaky():
            calls[0] += 1
            if calls[0] == 1:
                raise KeyError("once")
            if calls[0] == 2:
                time.sleep(0.2)
            return calls[0]

        return w.call(flaky)

    tracers = {}
    for side, tmod, tcls, wcls, ccls in (("port", trace, SpanTracer, Watchdog, ResilienceCounters),
                                         ("jax", jtrace, JSpanTracer, JWatchdog, JCounters)):
        t = tcls(tmp_path / f"{side}.json")
        prev = tmod.set_tracer(t)
        try:
            counters = ccls()
            assert program(wcls(0.1, retries=3, backoff_s=0.01, name="serve",
                                counters=counters)) == 2
        finally:
            tmod.set_tracer(prev)
        tracers[side] = (_strip(t.events()), counters.snapshot())
    assert tracers["port"] == tracers["jax"]
    assert tracers["port"][1] == {"resilience/serve_retries": 1, "resilience/serve_timeouts": 1}


# ---------------------------------------------------------------------------
# the Checkpointer's counters (C12) and chaos hook


def _kw(tmp_path, steps, **kw):
    return dict(d_in=16, dict_size=64, batch_size=64, num_tokens=64 * steps, enc_dtype="fp32",
                lr=1e-3, l1_coeff=0.1, log_backend="null", checkpoint_dir=str(tmp_path), **kw)


def _truncate(path):
    blob = path.read_bytes()
    path.write_bytes(blob[: len(blob) // 2])


def test_restore_past_a_truncated_save_counts_like_jax(tmp_path):
    """Save 1 truncated: the restore falls back to save 0, and the skip is
    on the restoring trainer's ``resilience/*`` channel, as JAX's."""
    snaps = {}
    for side, Cfg, Tr, Ck, kw in (
            ("jax", JCfg, jtrainer.Trainer, JCheckpointer,
             dict(mesh=jmesh.make_mesh(devices=jax.devices()[:1]))),
            ("port", CrossCoderConfig, trainer.Trainer, Checkpointer, dict(device="cpu"))):
        cfg = Cfg(**_kw(tmp_path / side, 8, prefetch=False))
        tr = Tr(cfg, checkpointer=Ck(cfg=cfg), **kw)
        for _ in range(3):
            tr.step()
        tr.save()
        tr.step()
        tr.save()
        tr.close()
        _truncate(tmp_path / side / "version_0" / "1.npz")
        tr2 = Tr(cfg, checkpointer=Ck(base_dir=tmp_path / side), **kw)
        assert tr2.restore()["step"] == 3
        with pytest.raises(ValueError, match="checksum"):
            tr2.restore(version_dir=tmp_path / side / "version_0", save=1)
        snaps[side] = tr2.resilience.snapshot()
        tr2.close()
    assert snaps["port"] == snaps["jax"] == {"resilience/corrupt_artifact_skips": 2}


def test_checkpointer_keeps_counters_handed_in(tmp_path):
    counters = ResilienceCounters()
    cfg = CrossCoderConfig(**_kw(tmp_path, 4))
    ck = Checkpointer(cfg=cfg, counters=counters)
    tr = trainer.Trainer(cfg, device="cpu", checkpointer=ck)
    assert ck.counters is counters and tr.resilience is not counters
    tr2 = trainer.Trainer(cfg, device="cpu", checkpointer=Checkpointer(cfg=cfg))
    assert tr2.checkpointer.counters is tr2.resilience
    tr.close()
    tr2.close()


def test_chaos_corrupt_save_hook_like_jax(tmp_path):
    out = {}
    for side, Cfg, Tr, Ck, Ch, kw in (
            ("jax", JCfg, jtrainer.Trainer, JCheckpointer, JChaos,
             dict(mesh=jmesh.make_mesh(devices=jax.devices()[:1]))),
            ("port", CrossCoderConfig, trainer.Trainer, Checkpointer, Chaos,
             dict(device="cpu"))):
        cfg = Cfg(**_kw(tmp_path / side, 8, prefetch=False))
        chaos = Ch.parse("corrupt-save@1:state")
        tr = Tr(cfg, checkpointer=Ck(cfg=cfg, chaos=chaos), chaos=chaos, **kw)
        tr.step()
        tr.save()
        tr.step()
        tr.save()
        tr.close()
        vdir = tmp_path / side / "version_0"
        tr2 = Tr(cfg, checkpointer=Ck(base_dir=tmp_path / side), **kw)
        out[side] = (Ck.verify_save(vdir, 0), Ck.verify_save(vdir, 1), tr2.restore()["step"],
                     tr2.resilience.snapshot(),
                     len((vdir / "1_train_state.npz").read_bytes()))
        tr2.close()
    assert out["port"][:4] == out["jax"][:4] == (
        True, False, 1, {"resilience/corrupt_artifact_skips": 1})


# ---------------------------------------------------------------------------
# the trainer under chaos


def _state_equal(a, b):
    assert a.step == b.step and a.opt_state.count == b.opt_state.count
    for x, y in ((a.params, b.params), (a.opt_state.mu, b.opt_state.mu),
                 (a.opt_state.nu, b.opt_state.nu), (a.aux or {}, b.aux or {})):
        assert x.keys() == y.keys()
        for k in x:
            assert torch.equal(x[k], y[k]), k


@pytest.mark.parametrize("prefetch", [False, True], ids=["inline", "prefetch"])
def test_serve_faults_through_the_watchdog_are_bitwise_the_clean_run(tmp_path, prefetch):
    kw = _kw(tmp_path, 8, prefetch=prefetch, harvest_timeout_s=0.1, harvest_retries=3,
             harvest_backoff_s=0.01)
    clean = trainer.Trainer(CrossCoderConfig(**kw), device="cpu")
    want = clean.train()
    cfg = CrossCoderConfig(**kw, chaos="stall@2:0.2,fail@4")
    tr = trainer.Trainer(cfg, device="cpu", chaos=Chaos.from_cfg_env(cfg))
    got = tr.train()
    assert got == want
    _state_equal(tr.state, clean.state)
    assert tr.resilience.snapshot() == {"resilience/harvest_timeouts": 1,
                                        "resilience/harvest_retries": 1}
    assert tr._serve_count == clean._serve_count == 8


def _jax_trainer(kw, spec, ckpt=True):
    cfg = JCfg(**kw)
    chaos = JChaos.parse(spec)
    return jtrainer.Trainer(cfg, mesh=jmesh.make_mesh(devices=jax.devices()[:1]),
                            checkpointer=JCheckpointer(cfg=cfg, chaos=chaos) if ckpt else None,
                            chaos=chaos)


def _port_trainer(kw, spec, state=None, ckpt=True):
    cfg = CrossCoderConfig(**kw)
    chaos = Chaos.parse(spec)
    return trainer.Trainer(cfg, device="cpu", state=state, chaos=chaos,
                           checkpointer=Checkpointer(cfg=cfg, chaos=chaos) if ckpt else None)


SNAPSHOT_CASES = {
    # JAX's integration run (tests/test_resilience.py), its stall shortened
    "integration": (30, "stall@3:0.2,nan@11,corrupt-save@2:state",
                    dict(log_every=3, save_every=5, guard_loss=True, max_rollbacks=3,
                         keep_saves=3, harvest_timeout_s=0.1, harvest_retries=4,
                         harvest_backoff_s=0.05)),
    "nan_guard": (30, "nan@11", dict(log_every=3, save_every=5, guard_loss=True,
                                     max_rollbacks=3)),
    # chip_smoke.py phase 16's run B: its schedule and spec at a tiny width
    "rs_b": (8, "nan@3,corrupt-save@1", dict(guard_loss=True, log_every=2, save_every=2,
                                             keep_saves=3, max_rollbacks=2)),
}


@pytest.mark.parametrize("case", sorted(SNAPSHOT_CASES))
def test_resilience_snapshot_equals_jaxs(tmp_path, case):
    """JAX's integration run (a stalled serve through the watchdog, a NaN
    batch under the guard, the newest save corrupted as it lands),
    ``nan@11`` under the guard, and phase 16's run B (a NaN batch whose
    state reaches the newest save, the save before it corrupted): the
    port's ``resilience/*`` snapshot, steps, serves and surviving saves
    equal JAX's; the port's run with prefetch on gives the same snapshot."""
    steps, spec, kw = SNAPSHOT_CASES[case]
    jkw = _kw(tmp_path / "j", steps, prefetch=False, **kw)
    jtr = _jax_trainer(jkw, spec)
    state = convert.train_state_from_numpy(jax.device_get(jtr.state), device="cpu")
    jout = jtr.train()
    tr = _port_trainer({**jkw, "checkpoint_dir": str(tmp_path / "t")}, spec, state=state)
    out = tr.train()
    assert tr.step_counter == jtr.step_counter == steps
    assert tr._serve_count == jtr._serve_count
    snap = tr.resilience.snapshot()
    assert snap == jtr.resilience.snapshot()
    assert snap["resilience/rollbacks"] == 1 and snap["resilience/skipped_batches"] >= 1
    if case == "integration":
        assert snap["resilience/harvest_timeouts"] == 1
        assert snap["resilience/corrupt_artifact_skips"] == 1
    if case == "rs_b":
        assert snap == {"resilience/rollbacks": 1, "resilience/corrupt_artifact_skips": 1,
                        "resilience/poisoned_save_skips": 1, "resilience/skipped_batches": 5}
    assert np.isfinite(out["loss"]) and np.isfinite(jout["loss"])
    assert all(torch.isfinite(v).all() for v in tr.state.params.values())
    pf = _port_trainer({**jkw, "prefetch": True, "checkpoint_dir": str(tmp_path / "p")}, spec,
                       state=state)
    pf.train()
    assert pf.resilience.snapshot() == snap and pf.step_counter == steps
    vdir = Checkpointer.latest_version_dir(tmp_path / "t")
    jdir = JCheckpointer.latest_version_dir(tmp_path / "j")
    assert Checkpointer.complete_saves(vdir) == JCheckpointer.complete_saves(jdir)


def test_rollback_during_an_active_profiler_window(tmp_path):
    """NaN at serve 11, detected at the log of step 12 while the legacy
    window (steps 10-14) captures: the rollback ends the capture, the
    retrained stretch starts another, the run ends with none open."""
    kw = _kw(tmp_path, 30, log_every=3, save_every=5, guard_loss=True, max_rollbacks=3,
             profile_dir=str(tmp_path / "trace"), prefetch=False)
    tr = _port_trainer(kw, "nan@11")
    out = tr.train()
    assert tr.step_counter == 30 and np.isfinite(out["loss"])
    assert tr.resilience.get("rollbacks") == 1
    files = sorted(p.name for p in (tmp_path / "trace").iterdir())
    assert files[0].startswith("window0_steps_10-12") and len(files) == 2, files


# ---------------------------------------------------------------------------
# the buffer's harvest hook against the JAX buffer

SEQ = 16                     # paged runtime: page 8 divides it; 15 rows a sequence
FILL_CHUNKS = 8              # 32 sequences, chunks of 4


class Stub:
    """Seeded stand-in harvest: acts[c, s] = E[token] + P[s], bf16-exact."""

    def __init__(self, d=32, vocab=257, seed=0):
        rng = np.random.default_rng(seed)
        self.E = rng.normal(size=(vocab, 2, d)).astype(np.float32) * 3
        self.P = rng.normal(size=(SEQ, 2, d)).astype(np.float32)

    def __call__(self, padded):
        return self.E[np.asarray(padded)] + self.P[None, : padded.shape[1]]


@pytest.fixture
def stub_harvest(monkeypatch):
    """The same stub behind both packages' ``_harvest_dev``; each keeps its
    real ``_harvest_job`` (the paged runtime: one dispatch a chunk)."""
    stub = Stub()
    monkeypatch.setattr(jbuf.PairedActivationBuffer, "_harvest_dev",
                        lambda self, p: jnp.asarray(stub(p)).astype(jnp.bfloat16))
    monkeypatch.setattr(buf.PairedActivationBuffer, "_harvest_dev",
                        lambda self, p: torch.from_numpy(stub(p)).to(torch.bfloat16))
    return stub


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(7).integers(1, 257, size=(256, SEQ), dtype=np.int64)


def _buf_kw(**kw):
    return dict(batch_size=30, buffer_mult=16, seq_len=SEQ, d_in=32, n_models=2,
                model_batch_size=4, norm_calib_batches=1, hook_point="blocks.2.hook_resid_pre",
                seed=3, harvest_runtime="paged", page_size=8, **kw)


def _buffers(tokens, spec, **kw):
    jb = jbuf.make_buffer(JCfg(**_buf_kw(**kw)), None, [{}, {}], tokens, chaos=JChaos.parse(spec))
    pb = buf.make_buffer(CrossCoderConfig(**_buf_kw(**kw)), None, [{}, {}], tokens,
                         device="cpu", chaos=Chaos.parse(spec))
    return jb, pb


def _raw(x):
    if torch.is_tensor(x):
        return x.contiguous().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def _serves(b, n, retry, tokens_at=True):
    """``n`` serves; a faulted serve is recorded and, with ``retry``,
    served once more (the watchdog's retry). ``tokens_at``: record the
    token position after each serve (with the overlap on it moves on the
    dispatcher thread, at a time of its own)."""
    out = []
    for _ in range(n):
        try:
            out.append(_raw(b.next_raw()).tobytes())
        except RuntimeError as e:           # ChaosFault, either package's
            out.append(f"{type(e).__name__}: {e}")
            if retry:
                out.append(_raw(b.next_raw()).tobytes())
        out.append((b.pointer, b.token_pointer) if tokens_at else b.pointer)
    return out


@pytest.mark.parametrize("overlap", ["off", "on"])
def test_fail_harvest_retry_serves_jaxs_stream(stub_harvest, tokens, overlap):
    """Two faults past the fill's chunks: each raises out of the serve
    whose refill reaches it (with the overlap on, out of the serve that
    drains the dispatcher thread), and the retried serve goes on with
    JAX's bytes, pointers and token position."""
    spec = f"fail-harvest@{FILL_CHUNKS + 1},fail-harvest@{FILL_CHUNKS + 5}"
    jb, pb = _buffers(tokens, spec, refill_overlap=overlap)
    off = overlap == "off"
    got, want = _serves(pb, 40, True, off), _serves(jb, 40, True, off)
    faults = [x for x in got if isinstance(x, str)]
    assert len(faults) == 2 and all("harvest chunk" in f for f in faults), faults
    assert got == want
    pb._quiesce_dispatch()
    jb._quiesce_dispatch()
    assert pb.state_dict()["token_pointer"] == jb.state_dict()["token_pointer"]
    pb.close()
    jb.close()


def test_a_fault_inside_the_fill_raises_from_the_constructor_as_jax(stub_harvest, tokens):
    spec = "fail-harvest@2"
    with pytest.raises(Exception, match="harvest chunk 2") as want:
        jbuf.make_buffer(JCfg(**_buf_kw()), None, [{}, {}], tokens, chaos=JChaos.parse(spec))
    with pytest.raises(ChaosFault, match="harvest chunk 2") as got:
        buf.make_buffer(CrossCoderConfig(**_buf_kw()), None, [{}, {}], tokens, device="cpu",
                        chaos=Chaos.parse(spec))
    assert str(got.value) == str(want.value)


def test_harvest_faults_through_the_trainers_watchdog_count_like_jax(stub_harvest, tokens,
                                                                     tmp_path):
    """A stalled and a failing harvest chunk past the fill, through each
    trainer's watchdog: the same counters, serves and stream position."""
    spec = f"stall-harvest@{FILL_CHUNKS + 1}:0.2,fail-harvest@{FILL_CHUNKS + 2}"
    kw = dict(harvest_timeout_s=0.1, harvest_retries=3, harvest_backoff_s=0.01, prefetch=False,
              dict_size=64, activation="batchtopk", topk_k=4, l1_coeff=0.0,
              num_tokens=30 * 12, log_backend="null", checkpoint_dir=str(tmp_path))
    jb, pb = _buffers(tokens, spec, **kw)
    jtr = jtrainer.Trainer(JCfg(**_buf_kw(**kw)), jb,
                           mesh=jmesh.make_mesh(devices=jax.devices()[:1]))
    tr = trainer.Trainer(CrossCoderConfig(**_buf_kw(**kw)), pb, device="cpu")
    for _ in range(10):
        jtr.step()
        tr.step()
    assert tr.resilience.snapshot() == jtr.resilience.snapshot() == {
        "resilience/harvest_timeouts": 1, "resilience/harvest_retries": 1}
    assert tr._serve_count == jtr._serve_count == 10
    assert (pb.pointer, pb.token_pointer) == (jb.pointer, jb.token_pointer)
    jtr.close()
    tr.close()
