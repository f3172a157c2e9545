"""The port's serve-replica board and drain hand-off
(crosscoder_tpu_torch/serve/replica.py) on the CPU: the board's
semantics as the JAX tests use them (announce and re-announce, retract,
peers, a replica never adopting its own spool, one winner per drain
record under two claimants), and a preempt → adopt hand-off whose served
results equal the JAX replica's on the same weights (the port's engines
built through crosscoder_tpu_torch/convert.py from the JAX
``serve.smoke.build_engine`` stack): equal index sets, vals within 1e-5
relative, diff within 1e-6 (tests/test_torch_serve.py's comparison)."""

import dataclasses
import json
import os
import threading

import jax
import numpy as np
import pytest

from crosscoder_tpu.ops import fused_encoder_topk as jfek
from crosscoder_tpu.ops import paged_attention as jpa
from crosscoder_tpu.serve import smoke as jsmoke
from crosscoder_tpu.serve.replica import ReplicaBoard as JBoard
from crosscoder_tpu.serve.replica import ServeReplica as JReplica
from crosscoder_tpu_torch import convert
from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.models import lm
from crosscoder_tpu_torch.obs import trace
from crosscoder_tpu_torch.serve import InferenceEngine, ReplicaBoard, ServeReplica, Shed
from crosscoder_tpu_torch.serve.smoke import build_engine

SEQ = 16


@pytest.fixture(autouse=True)
def _jax_kernels_plain():
    jfek.set_interpret(False)
    jpa.set_interpret(False)
    yield


def _docs(rng, vocab, lengths):
    return [rng.integers(1, vocab, size=int(n), dtype=np.int32) for n in lengths]


def test_board_membership(tmp_path):
    board = ReplicaBoard(tmp_path / "b")
    assert board.peers() == []
    board.announce("a", 1, queued=3)
    board.announce("b", 1)
    board.announce("a", 2, queued=0)          # a newer beat replaces the record
    assert {p["id"]: p["seq"] for p in board.peers()} == {"a": 2, "b": 1}
    assert [p["id"] for p in board.peers(exclude="a")] == ["b"]
    board.retract("a")
    board.retract("a")                         # idempotent
    assert [p["id"] for p in board.peers()] == ["b"]
    (tmp_path / "b" / "replica_torn.json").write_text("{not json")
    assert [p["id"] for p in board.peers()] == ["b"]   # a torn record reads as absent
    # the records are the JAX board's: each package reads the other's
    jboard = JBoard(tmp_path / "b")
    jboard.announce("c", 5, queued=1)
    assert {p["id"]: p["seq"] for p in board.peers()} == {"b": 1, "c": 5}
    assert {p["id"] for p in jboard.peers()} == {"b", "c"}


def test_drain_records_one_winner_and_never_own(tmp_path):
    board = ReplicaBoard(tmp_path / "b")
    reqs = [(0, np.arange(3, dtype=np.int32)), (1, np.arange(5, dtype=np.int32))]
    assert board.post_drain("a", reqs) == 2
    assert json.loads((tmp_path / "b" / "drain_a.json").read_text())["requests"] == [
        [0, [0, 1, 2]], [1, [0, 1, 2, 3, 4]]]
    assert board.claim_drains("a") == []       # never your own spool
    won = {}
    barrier = threading.Barrier(2)

    def claim(who):
        barrier.wait()
        won[who] = board.claim_drains(who)

    threads = [threading.Thread(target=claim, args=(w,)) for w in ("b", "c")]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted(len(v) for v in won.values()) == [0, 1]
    rec = next(v for v in won.values() if v)[0]
    assert rec["id"] == "a" and len(rec["requests"]) == 2
    assert board.claim_drains("d") == []       # claimed exactly once
    assert not os.path.exists(tmp_path / "b" / "drain_a.json")


def test_replica_drain_and_adopt(tmp_path):
    board = ReplicaBoard(tmp_path / "serve_board")
    eng_a, _, lm_cfg, _, _ = build_engine(serve_max_batch=8, device="cpu")
    eng_b, _, _, _, _ = build_engine(serve_max_batch=8, device="cpu")
    rep_a, rep_b = ServeReplica("a", eng_a, board), ServeReplica("b", eng_b, board)
    events = []

    class Tracer:
        def span(self, name, **args):
            return trace.NullTracer().span(name)

        def instant(self, name, **args):
            events.append((name, args))

    prev = trace.set_tracer(Tracer())
    try:
        rep_a.heartbeat()
        rep_b.heartbeat()
        assert {p["id"] for p in board.peers()} == {"a", "b"}
        docs = _docs(np.random.default_rng(9), lm_cfg.vocab_size, [3, SEQ, 6])
        for d in docs:
            eng_a.submit(d)
        assert rep_a.preempt() == 3
        assert eng_a.n_queued == 0
        assert board.peers(exclude="b") == []
        assert rep_b.heartbeat() == 3
        assert rep_b.heartbeat() == 0
    finally:
        trace.set_tracer(prev)
    assert events == [("drain_post", {"replica": "a", "requests": 3}),
                      ("drain_adopt", {"replica": "b", "requests": 3})]
    assert eng_b.n_queued == 3
    assert eng_b.stats()["serve/adopted_total"] == 3
    assert eng_a.stats()["serve/drained_total"] == 3
    assert len(eng_b.step(force=True)) == 3


def test_adopted_requests_face_admission(tmp_path):
    """An overloaded survivor sheds adopted requests as it sheds new ones:
    they count neither as adopted nor as queued."""
    board = ReplicaBoard(tmp_path / "b")
    eng, cfg, lm_cfg, _, _ = build_engine(serve_max_batch=2, device="cpu")
    rep = ServeReplica("b", eng, board)
    docs = _docs(np.random.default_rng(1), lm_cfg.vocab_size, [4] * (cfg.serve_queue + 3))
    board.post_drain("a", list(enumerate(docs)))
    assert rep.heartbeat() == cfg.serve_queue
    assert eng.n_queued == cfg.serve_queue
    with pytest.raises(Shed):
        eng.submit(docs[0])


def test_replica_never_adopts_own_spool(tmp_path):
    board = ReplicaBoard(tmp_path / "b")
    eng, _, lm_cfg, _, _ = build_engine(serve_max_batch=8, device="cpu")
    rep = ServeReplica("solo", eng, board)
    eng.submit(_docs(np.random.default_rng(10), lm_cfg.vocab_size, [4])[0])
    assert rep.preempt() == 1
    assert rep.heartbeat() == 0


def test_handoff_results_equal_the_jax_replicas(tmp_path):
    jeng_a, jcfg, jlm_cfg, jparams, jcc = jsmoke.build_engine(serve_max_batch=8)
    jeng_b = jsmoke.build_engine(serve_max_batch=8)[0]
    cfg = CrossCoderConfig.from_dict(jcfg.to_dict())
    lm_cfg = lm.LMConfig(**dataclasses.asdict(jlm_cfg))
    params = [convert.lm_params_from_numpy(jax.device_get(p), device="cpu") for p in jparams]
    ccp = convert.crosscoder_params_from_numpy(jax.device_get(jcc), device="cpu")
    eng_a = InferenceEngine(cfg, lm_cfg, params, ccp, device="cpu")
    eng_b = InferenceEngine(cfg, lm_cfg, params, ccp, device="cpu")
    docs = _docs(np.random.default_rng(3), lm_cfg.vocab_size, [1, 5, SEQ, 9, 2, 12, 7, 16])
    results = []
    for (ea, eb), root in (((jeng_a, jeng_b), "j"), ((eng_a, eng_b), "t")):
        board_cls, rep_cls = (JBoard, JReplica) if root == "j" else (ReplicaBoard, ServeReplica)
        board = board_cls(tmp_path / root)
        ra, rb = rep_cls("a", ea, board), rep_cls("b", eb, board)
        ra.heartbeat()
        for d in docs:
            ea.submit(d)
        assert ra.preempt() == 8
        assert rb.heartbeat() == 8
        results.append(eb.step(force=True))
    jres, tres = results
    assert len(jres) == len(tres) == 8
    for j, t, d in zip(jres, tres, docs):
        jv, jidx = np.asarray(j.vals, np.float32), np.asarray(j.idx)
        assert set(t.idx[t.vals != 0].tolist()) == set(jidx[jv != 0].tolist())
        order_t, order_j = np.argsort(t.idx), np.argsort(jidx)
        np.testing.assert_allclose(t.vals[order_t], jv[order_j], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(t.diff[order_t], np.asarray(j.diff)[order_j], atol=1e-6)
