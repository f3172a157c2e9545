"""The port's elastic membership (crosscoder_tpu_torch/resilience/elastic.py,
the elastic half of parallel/multihost.py, the buffer's reshard) against the
JAX package's, on the CPU; the cases follow tests/test_elastic.py.

- the elastic config rules: each JAX ``ValueError`` with its message;
- the single-process degenerations: no membership, an inactive controller,
  a shrink with nothing to shrink, no controller with elastic off;
- the controller side by side with JAX's: both packages' ``probe_liveness``
  (and ``clear_peer_loss``, ``peer_loss_flagged``) patched to the same
  scripted outcomes, the same returns and resilience counters;
- the survivor grid's arithmetic, its ``PeerLoss`` the JAX message;
- the buffer's reshard: after ``reshard(refill=True)`` every store (host
  and device, bf16 and int8, the refill overlap on and off; the mesh
  stores across a real 2 -> 1 gloo shrink) serves bitwise what a fresh
  buffer restored from the same ``state_dict`` serves.
"""

import copy
import time

import numpy as np
import pytest
import torch

from crosscoder_tpu.config import CrossCoderConfig as JCfg
from crosscoder_tpu.parallel import multihost as jmh
from crosscoder_tpu.resilience import elastic as jel
from crosscoder_tpu.resilience import elastic_drill as jdrill
from crosscoder_tpu.resilience.chaos import Chaos as JChaos
from crosscoder_tpu.utils.logging import ResilienceCounters as JCounters
from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.data import buffer as buf
from crosscoder_tpu_torch.models import lm
from crosscoder_tpu_torch.parallel import multihost
from crosscoder_tpu_torch.resilience import elastic as el
from crosscoder_tpu_torch.resilience import elastic_drill as drill
from crosscoder_tpu_torch.resilience.chaos import Chaos
from crosscoder_tpu_torch.train.trainer import Trainer
from crosscoder_tpu_torch.utils.logging import ResilienceCounters

from _torch_parallel_child import run_ranks

BASE = dict(d_in=32, dict_size=64, n_models=2, batch_size=16, num_tokens=16 * 50,
            log_backend="null")


def _cfg(**kw):
    return CrossCoderConfig(**{**BASE, **kw})


def _jcfg(**kw):
    return JCfg(**{**BASE, **kw})


# ---------------------------------------------------------------------------
# config


@pytest.mark.parametrize("kw", [
    dict(elastic="maybe"),
    dict(elastic="onn"),
    dict(elastic="on", elastic_heartbeat_s=0.0),
    dict(elastic="on", elastic_grace_s=0.5),
    dict(elastic="on", seq_shards=2, model_batch_size=4),
    dict(elastic="on", elastic_suspect_probes=0),
    dict(elastic_grow="sometimes"),
    dict(elastic_policy="best"),
    dict(elastic_grow="on", checkpoint_dir="ckpt"),
    dict(elastic="on", elastic_grow="on", checkpoint_dir=""),
    dict(elastic="on", elastic_grow="on", checkpoint_dir="ckpt", elastic_dwell_steps=-1),
    dict(elastic="on", elastic_grow="on", checkpoint_dir="ckpt", elastic_grow_debounce=0),
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_elastic_config_rules_match_jax(kw):
    with pytest.raises(ValueError) as jax_err:
        _jcfg(**kw)
    with pytest.raises(ValueError) as port_err:
        _cfg(**kw)
    assert str(port_err.value) == str(jax_err.value)


def test_elastic_config_fields_match_jax(tmp_path):
    kw = dict(elastic="on", elastic_heartbeat_s=2.0, elastic_grace_s=7.0,
              elastic_suspect_probes=3, elastic_grow="on", checkpoint_dir=str(tmp_path),
              elastic_dwell_steps=0, elastic_grow_debounce=1, elastic_policy="score")
    port, jax_ = _cfg(**kw), _jcfg(**kw)
    for k in kw:
        assert getattr(port, k) == getattr(jax_, k), k
    assert _cfg().elastic == _jcfg().elastic == "off"
    assert _cfg().elastic_grow == _jcfg().elastic_grow == "off"


# ---------------------------------------------------------------------------
# single-process degenerations


def test_membership_none_outside_elastic_runtime():
    assert multihost.membership() is jmh.membership() is None
    assert not multihost.peer_loss_flagged()
    # a probe outside any elastic world is vacuously healthy
    assert multihost.probe_liveness("p0", timeout_s=0.1)
    with pytest.raises(RuntimeError, match="outside an elastic runtime"):
        multihost.shrink_to_local()


def test_controller_inactive_single_process():
    ctl = el.ElasticController(_cfg(elastic="on"))
    jctl = jel.ElasticController(_jcfg(elastic="on"))
    for c in (ctl, jctl):
        assert not c.active()
        assert c.epoch() == 0
        assert not c.should_probe(0)
        # an ordinary software error is never a peer loss without a membership
        assert not c.confirm_peer_loss(RuntimeError("boom"))
    with pytest.raises(el.PeerLoss, match="no elastic membership"):
        ctl.shrink()


def test_trainer_elastic_off_has_no_controller():
    tr = Trainer(_cfg(), device="cpu")
    assert tr._elastic is None and tr.last_remesh is None
    tr.close()


def test_trainer_elastic_on_one_process_trains_with_an_inactive_controller():
    tr = Trainer(_cfg(elastic="on", num_tokens=16 * 3), device="cpu")
    assert tr._elastic is not None and not tr._elastic.active()
    out = tr.train()
    assert np.isfinite(out["loss"]) and tr.step_counter == 3
    assert tr.last_remesh is None and tr.resilience.snapshot() == {}


# ---------------------------------------------------------------------------
# the controller, side by side with JAX's


def _fast(**kw):
    return {"elastic": "on", "elastic_heartbeat_s": 0.01, "elastic_grace_s": 0.01, **kw}


def _pair(monkeypatch, cfg_kw, outcomes=None, barrier=None, chaos=None, active=False,
          flagged=None):
    """Both packages' controllers, each over the same scripted barrier:
    ``outcomes`` (a list of returns, one a call) or ``barrier`` (a function
    of nothing). Returns ``[(controller, counters, calls, cleared)]``."""
    out = []
    for pkg, cfg_fn, counters_cls, chaos_cls, membership_cls in (
            (el, _cfg, ResilienceCounters, Chaos, multihost.Membership),
            (jel, _jcfg, JCounters, JChaos, jmh.Membership)):
        calls, cleared = [], []
        script = iter(outcomes or [])

        def probe(seq, timeout_s, script=script, calls=calls):
            calls.append(seq)
            return barrier() if barrier is not None else next(script)

        monkeypatch.setattr(pkg.multihost, "probe_liveness", probe)
        monkeypatch.setattr(pkg.multihost, "clear_peer_loss",
                            lambda cleared=cleared: cleared.append(1))
        if flagged is not None:
            monkeypatch.setattr(pkg.multihost, "peer_loss_flagged", lambda: flagged)
        if active:
            m = membership_cls(epoch=0, num_processes=2, process_id=0,
                               coordinator_address="localhost:1")
            monkeypatch.setattr(pkg.multihost, "membership", lambda m=m: m)
            if pkg is el:
                monkeypatch.setattr(multihost, "collective_timeout_s", lambda: 60.0)
        counters = counters_cls()
        ctl = pkg.ElasticController(cfg_fn(**cfg_kw), counters=counters,
                                    chaos=chaos_cls.parse(chaos) if chaos else None)
        out.append((ctl, counters, calls, cleared))
    return out


def test_probe_hysteresis_absorbs_below_threshold(monkeypatch):
    sides = _pair(monkeypatch, _fast(elastic_suspect_probes=2), outcomes=[False, False])
    for ctl, counters, calls, cleared in sides:
        assert ctl.probe(0) is True      # first miss: a suspicion, absorbed
        assert cleared == [1]            # the latched flag is cleared too
        assert ctl.probe(1) is False     # second miss in a row: declared
        assert calls == ["p0", "p1"]
    (_, port, _, _), (_, jax_, _, _) = sides
    assert port.snapshot() == jax_.snapshot() == {
        "resilience/elastic_suspects": 2, "resilience/elastic_probes": 2}


def test_probe_hysteresis_resets_on_success(monkeypatch):
    sides = _pair(monkeypatch, _fast(elastic_suspect_probes=2),
                  outcomes=[False, True, False, True])
    for ctl, _, _, _ in sides:
        # miss-hit-miss-hit: the streak never reaches 2, no loss declared
        assert [ctl.probe(i) for i in range(4)] == [True] * 4
    assert sides[0][1].snapshot() == sides[1][1].snapshot()


def test_probe_flaky_chaos_skips_barrier_in_phase(monkeypatch):
    """A flaky host SKIPS the barrier but sits out the same grace window its
    peers spend timing out, so the probe phases stay aligned."""
    sides = _pair(monkeypatch, _fast(elastic_grace_s=0.05), barrier=lambda: True,
                  chaos="flaky@0:1.0")
    for ctl, _, calls, _ in sides:
        t0 = time.perf_counter()
        assert ctl.probe(0) is True
        assert not calls                             # the barrier was never entered
        assert time.perf_counter() - t0 >= 0.05      # but the grace was paid
    assert sides[0][1].snapshot() == sides[1][1].snapshot() == {
        "resilience/elastic_probes": 1, "resilience/elastic_skipped_probes": 1}


def test_probe_counts_slow_peer(monkeypatch):
    """A straggler peer shows up HERE as a successful barrier slower than the
    heartbeat: counted, never suspected."""
    sides = _pair(monkeypatch, _fast(elastic_heartbeat_s=0.01, elastic_grace_s=0.2),
                  barrier=lambda: time.sleep(0.03) or True)
    for ctl, _, _, _ in sides:
        assert ctl.probe(0) is True
    assert sides[0][1].snapshot() == sides[1][1].snapshot() == {
        "resilience/elastic_probes": 1, "resilience/elastic_slow_probes": 1}


def test_probe_slow_chaos_joins_late(monkeypatch):
    sides = _pair(monkeypatch, _fast(elastic_grace_s=0.2), barrier=lambda: True,
                  chaos="slow@1:40")
    for ctl, _, calls, _ in sides:
        t0 = time.perf_counter()
        assert [ctl.probe(i) for i in range(2)] == [True, True]
        assert time.perf_counter() - t0 >= 0.04 and calls == ["p0", "p1"]
    assert sides[0][1].snapshot() == sides[1][1].snapshot()


@pytest.mark.parametrize("flagged,barrier,want", [
    (True, True, True),        # the latched flag answers at once
    (False, False, True),      # a torn collective: the confirming barrier fails
    (False, True, False),      # an ordinary error: every rank arrived
])
def test_confirm_peer_loss_matches_jax(monkeypatch, flagged, barrier, want):
    sides = _pair(monkeypatch, _fast(), barrier=lambda: barrier, active=True,
                  flagged=flagged)
    for ctl, _, calls, _ in sides:
        assert ctl.active() and ctl.should_probe(0)
        assert ctl.confirm_peer_loss(RuntimeError("Connection closed by peer")) is want
        assert calls == ([] if flagged else ["x1"])
    assert sides[0][1].snapshot() == sides[1][1].snapshot() == {}


def test_probe_plans_of_the_stability_drill_match_jax():
    """Both drills' pinned chaos: skips at probes 3 and 7, the straggler at 5."""
    assert drill._STABILITY == jdrill._STABILITY
    assert drill._DRILL == jdrill._DRILL
    port, jax_ = Chaos.parse(drill._STABILITY["chaos"]), JChaos.parse(jdrill._STABILITY["chaos"])
    got = [port.on_probe(i) for i in range(drill._STABILITY["steps"])]
    assert got == [jax_.on_probe(i) for i in range(jdrill._STABILITY["steps"])]
    assert [i for i, b in enumerate(got) if b == "skip"] == [3, 7] and got[5] == 1.5


def test_the_elastic_world_refuses_a_collective_timeout_below_the_grace(monkeypatch):
    m = multihost.Membership(epoch=0, num_processes=2, process_id=0,
                             coordinator_address="localhost:1")
    monkeypatch.setattr(multihost, "membership", lambda: m)
    monkeypatch.setattr(multihost, "collective_timeout_s", lambda: 2.0)
    with pytest.raises(ValueError, match="collective timeout"):
        el.ElasticController(_cfg(elastic="on", elastic_grace_s=5.0))


def test_an_nccl_world_of_more_than_one_rank_is_refused():
    """A dead NCCL peer does not raise in Python (the watchdog ends the
    process), so an elastic NCCL world stops at one rank; refused before
    any store is made."""
    with pytest.raises(ValueError, match="NCCL needs one rank"):
        multihost.elastic_initialize("127.0.0.1:1", 2, 0, device="cpu", backend="nccl")
    assert multihost.membership() is None


def test_every_group_of_the_elastic_world_takes_its_bound(monkeypatch):
    """A new group does not inherit the world group's timeout: the grid's
    groups are given the elastic world's bound (PyTorch's default outside
    one), so a collective blocked on a peer that left gives up in time."""
    import datetime

    from crosscoder_tpu_torch.parallel import mesh as mesh_lib

    seen = []
    monkeypatch.setattr(mesh_lib.dist, "new_group",
                        lambda ranks, timeout=None: seen.append(timeout) or ranks)
    mesh_lib._groups([[0, 1]])
    monkeypatch.setattr(multihost._elastic, "timeout_s", 7.0)
    mesh_lib._groups([[0, 1], [2, 3]])
    assert seen == [None, datetime.timedelta(seconds=7), datetime.timedelta(seconds=7)]


# ---------------------------------------------------------------------------
# the survivor grid


@pytest.mark.parametrize("n,model", [(8, 4), (8, 1), (8, 8), (4, 2)])
def test_survivor_grid_keeps_the_tp_width(monkeypatch, n, model):
    monkeypatch.setattr(jel.jax, "device_count", lambda: n)
    jmesh = jel.ElasticController(_jcfg(elastic="on", model_axis_size=model)).survivor_mesh
    assert el.survivor_shape(n, model) == (n // model, model)
    if n == 8:      # the JAX grid over the test's 8 CPU devices
        shape = jmesh().shape
        assert (shape["data"], shape["model"]) == el.survivor_shape(n, model)


def test_survivor_grid_that_does_not_divide_raises_peer_loss():
    jctl = jel.ElasticController(_jcfg(elastic="on", dict_size=96, model_axis_size=3))
    with pytest.raises(jel.PeerLoss) as jax_err:
        jctl.survivor_mesh()
    with pytest.raises(el.PeerLoss) as port_err:
        el.survivor_shape(8, 3)
    assert str(port_err.value) == str(jax_err.value)


# ---------------------------------------------------------------------------
# the buffer's reshard


SEQ = 17
RESHARD_BASE = dict(batch_size=32, buffer_mult=32, seq_len=SEQ, d_in=32, n_models=2,
                    model_batch_size=4, norm_calib_batches=2, hook_point="blocks.2.hook_resid_pre",
                    seed=3, quant_block=16)


@pytest.fixture(scope="module")
def tiny_lm():
    # one intra-op thread: beside the suite's other workers, the tiny
    # harvest's thread pool only oversubscribes the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    lm_cfg = lm.LMConfig.tiny()
    params = [lm.init_params(lm_cfg, seed=s, device="cpu") for s in (0, 1)]
    tokens = np.random.default_rng(7).integers(1, 257, size=(256, SEQ), dtype=np.int64)
    yield lm_cfg, params, tokens
    torch.set_num_threads(threads)


@pytest.mark.parametrize("store,quant_buffer,overlap", [
    ("host", False, "off"), ("host", True, "off"), ("hbm", False, "off"), ("hbm", True, "off"),
    ("host", False, "on"), ("hbm", True, "on"),
])
def test_reshard_serves_what_a_restored_buffer_serves(tiny_lm, store, quant_buffer, overlap):
    lm_cfg, params, tokens = tiny_lm
    cfg = CrossCoderConfig(**RESHARD_BASE, buffer_device=store, quant_buffer=quant_buffer,
                           refill_overlap=overlap)
    b = buf.make_buffer(cfg, lm_cfg, params, tokens, device="cpu")
    for _ in range(5):          # mid-cycle: a refill cycle is in flight
        b.next_raw()
    snap = b.state_dict()
    b.prepare_reshard()
    b.reshard(None, refill=True)
    ref = buf.make_buffer(cfg, lm_cfg, params, tokens, device="cpu", lazy=True)
    ref.load_state_dict(snap)
    assert (b._dispatcher is None) == (ref._dispatcher is None)
    for i in range(12):         # past the next cycle's end
        got, want = b.next_raw(), ref.next_raw()
        assert torch.equal(got.view(torch.int16), want.view(torch.int16)), i
    b.close()
    ref.close()


def test_reshard_without_refill_waits_for_a_restore(tiny_lm):
    lm_cfg, params, tokens = tiny_lm
    cfg = CrossCoderConfig(**RESHARD_BASE, buffer_device="hbm")
    b = buf.make_buffer(cfg, lm_cfg, params, tokens, device="cpu")
    for _ in range(3):
        b.next_raw()
    snap = b.state_dict()
    b.prepare_reshard()
    b.reshard(None, refill=False)
    with pytest.raises(RuntimeError, match="never filled"):
        b.next_raw()
    b.load_state_dict(snap)
    ref = buf.make_buffer(cfg, lm_cfg, params, tokens, device="cpu", lazy=True)
    ref.load_state_dict(snap)
    for _ in range(4):
        assert torch.equal(b.next_raw().view(torch.int16), ref.next_raw().view(torch.int16))


def test_reshard_refuses_the_sequence_parallel_harvest(tiny_lm):
    lm_cfg, params, tokens = tiny_lm
    cfg = CrossCoderConfig(**RESHARD_BASE)
    b = buf.make_buffer(cfg, lm_cfg, params, tokens, device="cpu")
    b.cfg = copy.copy(cfg)
    b.cfg.seq_shards = 2        # as a sequence-parallel buffer's config says
    with pytest.raises(ValueError, match="seq_shards > 1"):
        b.reshard(None)


def test_mesh_stores_reshard_across_a_two_to_one_shrink(tmp_path):
    """Two gloo ranks, one a host: the bf16 and int8 mesh stores (the int8
    with the refill overlap pumped inline) serve 5 batches on the 2 x 1
    grid; rank 1 leaves, rank 0 shrinks to epoch 1 through the controller
    and reshards both onto the 1 x 1 grid, whose stream equals a fresh
    restored buffer's, bitwise."""
    task = {"kind": "elastic", "local": 1, "grid": [2, 1], "serves": 5, "after": 10,
            "base": dict(RESHARD_BASE, buffer_device="hbm"),
            "variants": {"bf16": {}, "int8": {"quant_buffer": True, "refill_overlap": "on"}}}
    ranks = run_ranks(2, task, tmp_path)
    assert ranks[0]["classes"] == {"bf16": "MeshPairedActivationBuffer",
                                   "int8": "QuantMeshPairedActivationBuffer"}
    r0 = ranks[0]
    assert r0["epoch"] == 1 and r0["world"] == 1 and r0["grid"] == (1, 1)
    # the store lives on with rank 0, so the survivors' view keeps its address
    # (JAX's records None: its coordination service is torn down; ROADMAP C14)
    assert r0["address"].startswith("127.0.0.1:")
    assert r0["counters"] == {"resilience/remeshes": 1}
    assert set(r0["streams"]) == {"bf16", "int8"}
    for name, s in r0["streams"].items():
        np.testing.assert_array_equal(s["got"], s["want"], err_msg=name)
    assert "streams" not in ranks[1]


def test_tensor_parallel_store_reshards_across_a_host_loss(tmp_path):
    """Two hosts of two gloo ranks on a 2 x 2 grid, the harvest over
    tensor-parallel LM params (``shard_lm``): host 1 leaves, host 0's ranks
    shrink to a 1 x 2 grid (the TP width kept, each rank its model index)
    and the resharded bf16 and int8 stores, their TP params pointed at the
    new model group, serve bitwise what fresh restored buffers serve."""
    task = {"kind": "elastic", "local": 2, "grid": [2, 2], "serves": 5, "after": 8,
            "base": dict(RESHARD_BASE, buffer_device="hbm", shard_lm=True),
            "variants": {"bf16": {}, "int8": {"quant_buffer": True}}}
    ranks = run_ranks(4, task, tmp_path)
    for r in ranks[:2]:
        assert r["epoch"] == 1 and r["world"] == 2 and r["grid"] == (1, 2)
        assert set(r["streams"]) == {"bf16", "int8"}
        for name, s in r["streams"].items():
            np.testing.assert_array_equal(s["got"], s["want"], err_msg=name)
    assert all("streams" not in r for r in ranks[2:])


def test_shrink_off_the_coordinator_host_raises_peer_loss(monkeypatch):
    """Only rank 0's host can re-mesh (the store lives there); any other
    rank raises ``PeerLoss``, which ends its run, as JAX's non-coordinator
    process does."""
    m = multihost.Membership(epoch=0, num_processes=4, process_id=2,
                             coordinator_address="localhost:1")
    monkeypatch.setattr(multihost, "membership", lambda: m)
    monkeypatch.setattr(multihost, "collective_timeout_s", lambda: 60.0)
    monkeypatch.setattr(multihost, "on_coordinator_host", lambda: False)
    ctl = el.ElasticController(_cfg(elastic="on"))
    with pytest.raises(el.PeerLoss, match="non-coordinator host"):
        ctl.shrink()
