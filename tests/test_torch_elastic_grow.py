"""The port's elastic scale-up protocol and grid policy
(crosscoder_tpu_torch/resilience/elastic.py's grow side,
crosscoder_tpu_torch/resilience/fleet.py) against the JAX package's, on the
CPU; the cases follow tests/test_elastic.py's board and policy tests:

- the rendezvous board: a round trip through both packages' boards over
  the same files (each reads what the other wrote), the courtship's timeout
  and admit, the grant, ``clear_admit``;
- ``_poll_candidates``: the port's and JAX's controllers poll the same
  board files through the same announce sequence and give equal stable
  sets; an announce of another rank count than a host's is not admitted;
- ``grow_ready``'s gates (no board, no shrunk world, inside the dwell, off
  the cadence) on both controllers over the same membership;
- ``grow`` without a world raises ``GrowAborted``; with ``cfg.tuned`` (the
  tuner, A9a) the controller's ``note_remesh`` re-tunes and counts
  ``resilience/retune_*`` as JAX's does, and the policy takes the
  artifact's grid;
- ``FleetPolicy``: ``candidate_shapes`` and the fixed ``choose`` equal to
  JAX's over a grid of configs (the ``ValueError`` included); the score
  ranking sorted, ``choose`` its head, its wire term at ``train_dp`` the
  bytes ``comm_model.profile_width`` counts;
- ``multihost.grow_to``'s refusals (a target world of one rank, an epoch
  not past the current one, an NCCL world);
- C15: two gloo survivors of one host get the same ``grow_ready`` answer,
  stable set and admit record at the same step; with no joiner coming the
  grow aborts on both and the world goes on narrow at an epoch past the
  burned one.
"""

import time

import pytest

from crosscoder_tpu.config import CrossCoderConfig as JCfg
from crosscoder_tpu.parallel import multihost as jmh
from crosscoder_tpu.resilience import elastic as jel
from crosscoder_tpu.resilience import fleet as jfleet
from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.parallel import comm_model
from crosscoder_tpu_torch.parallel import multihost
from crosscoder_tpu_torch.resilience import elastic as el
from crosscoder_tpu_torch.resilience import fleet

from _torch_parallel_child import run_ranks

BASE = dict(d_in=32, dict_size=64, n_models=2, batch_size=16, num_tokens=16 * 50,
            log_backend="null")


def _cfg(**kw):
    return CrossCoderConfig(**{**BASE, **kw})


def _jcfg(**kw):
    return JCfg(**{**BASE, **kw})


def _grow(tmp_path, **kw):
    return dict(elastic="on", elastic_grow="on", checkpoint_dir=str(tmp_path),
                elastic_grow_debounce=2, elastic_dwell_steps=2, **kw)


def _pair(tmp_path, **kw):
    """The port's and JAX's controllers over one board directory."""
    return (el.ElasticController(_cfg(**_grow(tmp_path, **kw))),
            jel.ElasticController(_jcfg(**_grow(tmp_path, **kw))))


# ---------------------------------------------------------------------------
# the rendezvous board


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_board_round_trip_reads_across_packages(tmp_path, writer):
    boards = {"port": el.RendezvousBoard(tmp_path / "b"),
              "jax": jel.RendezvousBoard(tmp_path / "b")}
    w, r = boards[writer], boards["jax" if writer == "port" else "port"]
    for b in boards.values():
        assert b.read_grant() is None and b.poll_announces() == [] and b.read_admit() is None
    w.post_grant({"serve": 7})
    w.announce("c1", 4, seq=0)
    w.announce("c2", 4, seq=3)
    for b in boards.values():
        assert b.read_grant() == {"serve": 7}
        assert b.poll_announces() == [{"id": "c1", "devices": 4, "seq": 0},
                                      {"id": "c2", "devices": 4, "seq": 3}]
    r.retract("c1")
    assert [x["id"] for x in w.poll_announces()] == ["c2"]
    w.post_admit({"epoch": 2, "assignments": {"c2": 1}})
    w.post_admit({"epoch": 1, "assignments": {}})
    assert r.read_admit()["epoch"] == w.read_admit()["epoch"] == 2    # the newest wins
    r.clear_admit(2)
    assert w.read_admit()["epoch"] == 1
    # every write was atomic: no temporary file is left
    assert not list((tmp_path / "b").glob("*.tmp-*"))


@pytest.mark.parametrize("pkg", [el, jel], ids=["port", "jax"])
def test_announce_until_admitted_beats_and_times_out(tmp_path, pkg):
    board = pkg.RendezvousBoard(tmp_path / "b")
    with pytest.raises(TimeoutError, match="not admitted"):
        board.announce_until_admitted("c1", 4, timeout_s=0.3, beat_s=0.05)
    assert board.poll_announces() == []        # the courtship retracted its announce


@pytest.mark.parametrize("pkg", [el, jel], ids=["port", "jax"])
def test_announce_until_admitted_returns_the_record(tmp_path, pkg):
    board = pkg.RendezvousBoard(tmp_path / "b")
    board.post_admit({"epoch": 2, "assignments": {"c1": 1}})
    admit = board.announce_until_admitted("c1", 4, timeout_s=5.0, beat_s=0.05)
    assert admit["assignments"]["c1"] == 1
    assert board.poll_announces() == []


def test_open_rejoin_window_posts_the_grant(tmp_path):
    ctl, jctl = _pair(tmp_path)
    ctl.open_rejoin_window(11)
    assert jctl._board.read_grant() == {"serve": 11}
    jctl.open_rejoin_window(12)
    assert ctl._board.read_grant() == {"serve": 12}
    # inert (no board) when the grow plane is off
    el.ElasticController(_cfg(elastic="on")).open_rejoin_window(3)


# ---------------------------------------------------------------------------
# the debounce


def test_poll_candidates_equal_jax_through_an_announce_sequence(tmp_path):
    ctl, jctl = _pair(tmp_path, elastic_grace_s=5.0)
    board = ctl._board
    sides = (ctl, jctl)

    def poll():
        got = [[c["id"] for c in c_._poll_candidates()] for c_ in sides]
        assert got[0] == got[1], got
        return got[0]

    board.announce("c1", 1, seq=0)
    assert poll() == []                 # first sighting: a streak of 1
    assert poll() == []                 # between beats: the streak holds
    board.announce("c2", 1, seq=0)
    board.announce("c1", 1, seq=1)
    assert poll() == ["c1"]             # an observed advance: a streak of 2
    board.announce("c2", 1, seq=1)
    assert poll() == ["c1", "c2"]
    # c1 stalled past the grace window: its courtship restarts from scratch
    for c_ in sides:
        seq, streak, _ = c_._cand_freshness["c1"]
        c_._cand_freshness["c1"] = (seq, streak, time.monotonic() - 10.0)
    assert poll() == ["c2"]
    # a vanished announce drops out
    board.retract("c2")
    assert poll() == []
    assert "c2" not in ctl._cand_freshness and "c2" not in jctl._cand_freshness


def test_an_announce_of_another_rank_count_is_not_admitted(tmp_path):
    """A host comes back whole (C15): an announce whose ``devices`` is not
    the world's ranks a host (1 outside an elastic world) never stabilises."""
    ctl = el.ElasticController(_cfg(**_grow(tmp_path)))
    for seq in range(3):
        ctl._board.announce("c4", 4, seq=seq)
        assert ctl._poll_candidates() == []
    assert ctl._cand_freshness["c4"][1] == 3


# ---------------------------------------------------------------------------
# grow_ready's gates and the grow's refusals


def test_grow_ready_gates_match_jax(tmp_path, monkeypatch):
    for c in (el.ElasticController(_cfg(elastic="on")),
              jel.ElasticController(_jcfg(elastic="on"))):
        assert c._board is None and not c.grow_ready(0)      # no board
    ctl, jctl = _pair(tmp_path, stop_poll_every=2)
    for c in (ctl, jctl):
        assert not c.grow_ready(0)                           # no membership at all
    # a shrunk world (one rank: JAX's single process), a stable candidate
    for pkg, membership in ((el, multihost.Membership), (jel, jmh.Membership)):
        m = membership(epoch=1, num_processes=1, process_id=0,
                       coordinator_address="localhost:1")
        monkeypatch.setattr(pkg.multihost, "membership", lambda m=m: m)
    for c in (ctl, jctl):
        c.note_remesh(4)
    ctl._board.announce("c1", 1, seq=0)
    got = {}
    for step in (4, 5, 6, 7, 8):
        ctl._board.announce("c1", 1, seq=step)
        got[step] = [ctl.grow_ready(step), jctl.grow_ready(step)]
    # 4: inside the dwell; 5: off the cadence and inside the dwell; 6: the
    # first poll (a first sighting); 7: off the cadence; 8: an advance
    assert got == {4: [False, False], 5: [False, False], 6: [False, False],
                   7: [False, False], 8: [True, True]}
    assert ([c["id"] for c in ctl._stable_candidates]
            == [c["id"] for c in jctl._stable_candidates] == ["c1"])
    # a wider world never polls
    m = multihost.Membership(epoch=1, num_processes=2, process_id=0,
                             coordinator_address="localhost:1")
    monkeypatch.setattr(multihost, "membership", lambda: m)
    assert not ctl.grow_ready(10)


def test_trainer_with_elastic_grow_trains_on_one_process(tmp_path):
    """The grow is ported: with no elastic world the controller holds the
    board and the policy, never polls, and the Trainer trains and saves."""
    from crosscoder_tpu_torch.checkpoint import Checkpointer
    from crosscoder_tpu_torch.train.trainer import Trainer

    cfg = _cfg(**_grow(tmp_path), num_tokens=16 * 3)
    tr = Trainer(cfg, device="cpu", checkpointer=Checkpointer(tmp_path, cfg=cfg))
    assert isinstance(tr._elastic._policy, fleet.FleetPolicy)
    out = tr.train()
    assert out["loss"] == out["loss"] and tr.step_counter == 3
    assert tr.last_grow is None and tr.resilience.snapshot() == {}
    assert not (tmp_path / "elastic_board").exists()


def test_grow_without_a_world_raises_grow_aborted(tmp_path):
    ctl, jctl = _pair(tmp_path)
    for c, exc in ((ctl, el.GrowAborted), (jctl, jel.GrowAborted)):
        with pytest.raises(exc, match="shrunk"):
            c.grow(0, save_version=0, version_dir=str(tmp_path), save_step=0)


def test_tuned_raises_naming_a9(tmp_path, monkeypatch):
    """What replaced A9's refusal: a pinned artifact builds the controller,
    each ``note_remesh`` re-tunes at the world's size (JAX's device count)
    and counts its status as JAX's controller does (``current``, ``stale``,
    ``cache_hit``; ``error`` without stopping the re-mesh), and the policy
    takes the artifact's grid."""
    from crosscoder_tpu.tune import artifact as jart
    from crosscoder_tpu.utils.logging import ResilienceCounters as JCounters
    from crosscoder_tpu_torch.tune import artifact
    from crosscoder_tpu_torch.utils.logging import ResilienceCounters

    p = artifact.TunedArtifact("train", {"refill_frac": 0.25},
                               {"n_devices": 1, "n_model": 1}).save(tmp_path / "TUNED.json")
    kw = dict(_grow(tmp_path), tuned=str(p))
    ctl = el.ElasticController(_cfg(**kw), counters=ResilienceCounters())
    jctl = jel.ElasticController(_jcfg(**kw), counters=JCounters())
    world = {"n": 1}
    monkeypatch.setattr(multihost, "world_size", lambda: world["n"])
    monkeypatch.setattr(jel.jax, "device_count", lambda: world["n"])
    for n, cache in ((1, None), (2, None), (2, (0.5, "d2m1")), (1, None)):
        if cache is not None:
            artifact.TunedArtifact("train", {"refill_frac": cache[0]},
                                   {"n_devices": n, "n_model": 1}).save(
                artifact.cache_path(tmp_path, cache[1]))
        world["n"] = n
        ctl.note_remesh(3)
        jctl.note_remesh(3)
        assert ctl.counters.snapshot() == jctl.counters.snapshot()
        assert ctl.cfg.refill_frac == jctl.cfg.refill_frac
    assert ctl.counters.snapshot() == {"resilience/resilience/retune_current": 1,
                                       "resilience/resilience/retune_stale": 2,
                                       "resilience/resilience/retune_cache_hit": 1}
    assert ctl.cfg.tuned == str(artifact.cache_path(tmp_path, "d2m1"))

    def broken(cfg, n):
        raise OSError("disk gone")

    monkeypatch.setattr(artifact, "on_remesh", broken)
    monkeypatch.setattr(jart, "on_remesh", broken)
    ctl.note_remesh(4)
    jctl.note_remesh(4)
    assert ctl.counters.snapshot() == jctl.counters.snapshot()
    assert ctl.counters.get("resilience/retune_error") == 1
    assert ctl._last_remesh_step == 4
    choice = fleet.FleetPolicy(_cfg(tuned=str(p))).choose(1)
    assert (choice.n_data, choice.n_model, choice.detail["policy"]) == (1, 1, "tuned")


@pytest.mark.parametrize("kw,match", [
    (dict(num_processes=1, epoch=1), "multi-process target world"),
    (dict(num_processes=2, epoch=0), "not past the current epoch"),
])
def test_grow_to_refusals(monkeypatch, kw, match):
    m = multihost.Membership(epoch=0, num_processes=1, process_id=0,
                             coordinator_address="127.0.0.1:1")
    monkeypatch.setattr(multihost._elastic, "membership", m)
    with pytest.raises(ValueError, match=match):
        multihost.grow_to("127.0.0.1:1", kw["num_processes"], 0, kw["epoch"])


def test_grow_to_refuses_an_nccl_world(monkeypatch):
    import torch

    monkeypatch.setattr(multihost, "_backend_kwargs", lambda dev, backend: ("nccl", {}))
    try:
        with pytest.raises(ValueError, match="NCCL needs one rank"):
            multihost.grow_to("127.0.0.1:1", 2, 1, 2, device=torch.device("cpu"),
                              timeout_s=1.0, local_world_size=1)
    finally:
        multihost._elastic.reset()


# ---------------------------------------------------------------------------
# FleetPolicy


GRID = [dict(), dict(dict_size=96), dict(dict_size=128), dict(model_axis_size=2),
        dict(quant_grads=True), dict(shard_sources=True), dict(dict_size=60)]


@pytest.mark.parametrize("kw", GRID, ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items())
                         or "base")
@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 12, 16])
def test_candidate_shapes_and_fixed_choice_equal_jax(kw, n):
    pol, jpol = fleet.FleetPolicy(_cfg(**kw)), jfleet.FleetPolicy(_jcfg(**kw))
    assert pol.candidate_shapes(n) == jpol.candidate_shapes(n)
    try:
        want = jpol.choose(n)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            pol.choose(n)
        assert str(got.value) == str(e)
        return
    got = pol.choose(n)
    assert (got.n_data, got.n_model, got.score_ms, got.detail) == \
        (want.n_data, want.n_model, want.score_ms, want.detail)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_score_policy_ranks_sorted_and_choose_is_its_head(n):
    cfg = _cfg(elastic_policy="score", d_in=2304, dict_size=2 ** 14, batch_size=4096)
    pol = fleet.FleetPolicy(cfg)
    ranked = pol.rank(n)
    assert [(c.n_data, c.n_model) for c in ranked] and len(ranked) == len(
        pol.candidate_shapes(n))
    keys = [(c.score_ms, -c.n_data) for c in ranked]
    assert keys == sorted(keys)
    assert all(c.detail["policy"] == "score" for c in ranked)
    head = pol.choose(n)
    assert (head.n_data, head.n_model) == (ranked[0].n_data, ranked[0].n_model)
    # the tenant axis scales every score alike: the same order
    three = pol.rank(n, n_tenants=3)
    assert [(c.n_data, c.n_model) for c in three] == [(c.n_data, c.n_model) for c in ranked]
    assert three[0].score_ms == pytest.approx(3 * ranked[0].score_ms)


def test_score_policy_falls_back_to_the_fixed_shape_on_an_empty_ranking(monkeypatch):
    pol = fleet.FleetPolicy(_cfg(elastic_policy="score", model_axis_size=2))
    monkeypatch.setattr(pol, "rank", lambda n, k=1: [])
    got = pol.choose(8)
    assert (got.n_data, got.n_model, got.detail) == (4, 2, {"policy": "fixed"})


@pytest.mark.parametrize("n", [2, 4, 8])
def test_score_wire_term_is_the_counted_dp_bytes(n):
    """The policy prices the DP sum it models; at ``train_dp`` that is what
    one step of the mesh trainer moves, counted under the fake group."""
    shape = dict(dict_size=256, d_in=32, batch_size=64)
    (prof,) = comm_model.profile_width(n, programs=("train",), device="cpu", **shape)
    cfg = comm_model.program_config("train_dp", n, 1, **shape)
    model = fleet.FleetPolicy(cfg).step_profile(n, 1)
    assert model.bytes_by_op["all-reduce"] == prof.bytes_by_op["all-reduce"]
    assert comm_model.wire_bytes(model, axis_size=n) == comm_model.wire_bytes(prof)
    ranked = {(c.n_data, c.n_model): c for c in fleet.FleetPolicy(
        cfg.replace(elastic_policy="score")).rank(n)}
    assert ranked[(n, 1)].detail["wire_bytes"] == comm_model.wire_bytes(prof)


# ---------------------------------------------------------------------------
# C15: more than one survivor rank


def test_two_survivors_agree_on_grow_ready_and_the_admit_record(tmp_path):
    ranks = run_ranks(2, {"kind": "grow", "case": "agree", "local": 2, "timeout_s": 3.0,
                          "root": str(tmp_path)}, tmp_path, timeout=90.0)
    r0, r1 = ranks
    assert r0["ready"] == r1["ready"] == [False, True, True]
    assert r0["stable"] == r1["stable"] == [[], ["host1"], ["host1"]]
    admit = r0["admit"]
    assert admit == r1["admit"]
    # host-major: the returned host of 2 ranks takes ranks 2 and 3
    assert admit["assignments"] == {"host1": 2} and admit["num_processes"] == 4
    assert admit["epoch"] == 1 and (admit["n_data"], admit["n_model"]) == (4, 1)
    assert admit["local_world_size"] == 2 and admit["backend"] == "gloo"
    assert admit["coordinator_address"].startswith("127.0.0.1:")
    for r in ranks:
        # nobody came: the grow aborted, epoch 1 burned, narrow at epoch 2
        assert r["grown"] is None
        assert r["counters"] == {"resilience/grow_aborts": 1}
        assert r["epoch"] == 2 and r["world"] == 2 and r["grid"] == (2, 1)
    assert not (tmp_path / "elastic_board" / "admit_1.json").exists()
