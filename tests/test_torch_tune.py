"""The port's autotuner (crosscoder_tpu_torch/tune/) against the JAX
package's (crosscoder_tpu/tune/, scripts/tune_report.py) on the CPU; the
cases follow tests/test_tune.py:

- the lattice prunes exactly JAX's points (each objective's default axes
  over several base configs, and axes with invalid points);
- with the cost constants set to JAX's and the same stubbed step cost,
  ``price_candidate`` predicts JAX's numbers to 1e-12 relative and the
  ranking is JAX's order; the port's own step cost counts the leaves O1
  reads and writes and the score policy's operations and wire;
- the rigged race picks the planted winner, a violator is discarded and
  counted, all-rejected and empty lattices raise, the default knobs are
  always calibrated; the same rigged search gives JAX's artifact;
- the artifact: a round trip, the same breakages rejected, the JSON byte
  for byte JAX's, a JAX-written artifact applied in the port and the
  reverse with equal ``config_hash``; ``on_remesh``'s four statuses as
  JAX's; ``FleetPolicy`` takes the tuned grid as JAX's does;
  ``from_cli``'s resolution order as JAX's;
- the report renders and rejects as ``scripts/tune_report.py`` does;
- ``step_identity_gate`` passes a data-plane candidate and rejects a step
  knob smuggled past ``STEP_FIELDS``; ``measure_window`` on the CPU
  returns JAX's keys; the smoke exits 0; ``--tuned`` through
  ``train.main`` is bitwise the hand-passed flags; every entry point asks
  for the card when no device is named.
"""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from crosscoder_tpu.config import CrossCoderConfig as JCfg
from crosscoder_tpu.obs.registry import MetricsRegistry as JRegistry
from crosscoder_tpu.resilience import fleet as jfleet
from crosscoder_tpu.tune import artifact as jart
from crosscoder_tpu.tune import autotune as jautotune
from crosscoder_tpu.tune import calibrate as jcal
from crosscoder_tpu.tune import lattice as jlat
from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.obs.registry import MetricsRegistry
from crosscoder_tpu_torch.resilience import fleet
from crosscoder_tpu_torch.train.state import Optimizer, init_train_state
from crosscoder_tpu_torch.tune import artifact, autotune, calibrate, lattice, report
from crosscoder_tpu_torch.tune import smoke

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(d_in=8, dict_size=32, batch_size=32, enc_dtype="fp32", log_backend="null")
_FLAT_COST = {"flops": 1e9, "bytes_accessed": 1e8, "wire_bytes": 2e6}


def tiny(**kw):
    return CrossCoderConfig(**{**TINY, **kw})


def jtiny(**kw):
    return JCfg(**{**TINY, **kw})


def _load_script(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def flat_step_cost(monkeypatch):
    """The same constant device terms on both sides: no compiler runs on
    JAX's, and pricing differs only through the data-plane model."""
    monkeypatch.setattr(lattice, "_step_cost", lambda cand, n_devices: dict(_FLAT_COST))
    monkeypatch.setattr(jlat, "_step_cost", lambda cand, n_devices: dict(_FLAT_COST))


@pytest.fixture
def jax_constants(monkeypatch):
    """The port's cost constants set to the JAX package's (its wire term is
    priced at JAX's HBM rate)."""
    for name in ("PEAK_FLOPS", "HBM_GBPS", "HOST_DISPATCH_MS", "HARVEST_REF_MS"):
        monkeypatch.setattr(lattice, name, getattr(jlat, name))
    monkeypatch.setattr(lattice, "WIRE_GBPS", jlat.HBM_GBPS)


def _knob_rows(cands):
    return [json.dumps(c.knobs, sort_keys=True) for c in cands]


# ---------------------------------------------------------------------------
# the lattice


BASES = [dict(), dict(seq_len=64), dict(seq_len=48, page_size=16), dict(quant_block=8),
         dict(refill_overlap="on", fleet="on", fleet_tenants="a;b;c"),
         dict(activation="topk", topk_k=4, l1_coeff=0.0, sparse_bwd="on")]


@pytest.mark.parametrize("objective", lattice.OBJECTIVES)
@pytest.mark.parametrize("base", BASES, ids=lambda b: ",".join(f"{k}={v}" for k, v in b.items())
                         or "default")
def test_default_axes_lattice_is_jaxs(objective, base):
    cfg, jcfg = tiny(**base), jtiny(**base)
    axes = lattice.default_axes(cfg, objective)
    assert axes == jlat.default_axes(jcfg, objective)
    cands, pruned = lattice.enumerate_lattice(cfg, axes)
    jcands, jpruned = jlat.enumerate_lattice(jcfg, axes)
    assert pruned == jpruned
    assert _knob_rows(cands) == _knob_rows(jcands)
    assert [c.base_sig for c in cands] == [c.base_sig for c in jcands]
    assert [lattice._step_signature(c) for c in cands] == [
        jlat._step_signature(c) for c in jcands]


@pytest.mark.parametrize("axes", [
    {"refill_frac": (0.25, 0.5, 0.75), "refill_dispatch_batch": (0, 4), "prefetch": (False, True)},
    {"refill_frac": (0.9,)},
    {"page_size": (16, 24, 32), "seq_len": (32, 48)},
    {"topk_k": (4, 64), "aux_k": (-1, 8, 64)},
], ids=["frac-batch", "all-invalid", "pages", "topk"])
def test_lattice_prunes_exactly_jaxs_points(axes):
    cfg = tiny(activation="topk", l1_coeff=0.0)
    cands, pruned = lattice.enumerate_lattice(cfg, axes)
    jcands, jpruned = jlat.enumerate_lattice(jtiny(activation="topk", l1_coeff=0.0), axes)
    assert (pruned, _knob_rows(cands)) == (jpruned, _knob_rows(jcands))
    for c in cands:
        for k, v in c.knobs.items():
            assert getattr(c.cfg, k) == v
    if axes == {"refill_frac": (0.9,)}:
        assert cands == [] and pruned == 1


def test_default_axes_refuse_an_unknown_objective():
    with pytest.raises(ValueError, match="objective"):
        lattice.default_axes(tiny(), "nope")


# ---------------------------------------------------------------------------
# stage-1 pricing


@pytest.mark.parametrize("objective", lattice.OBJECTIVES)
@pytest.mark.parametrize("n_devices", [1, 4])
def test_pricing_is_jaxs_under_jaxs_constants(flat_step_cost, jax_constants, objective,
                                              n_devices):
    base = dict(seq_len=64, fleet_tenants="a;b;c") if objective == "fleet" else dict(seq_len=64)
    if objective == "fleet":
        base["fleet"] = "on"
    cfg, jcfg = tiny(**base), jtiny(**base)
    axes = lattice.default_axes(cfg, objective)
    if objective == "train":
        axes = dict(axes, refill_dispatch_batch=(1, 2, 4, 8))
    cands, _ = lattice.enumerate_lattice(cfg, axes)
    jcands, _ = jlat.enumerate_lattice(jcfg, axes)
    for seed in (0, 7):
        ranked = lattice.rank_candidates(cands, objective, n_devices, seed)
        jranked = jlat.rank_candidates(jcands, objective, n_devices, seed)
        assert _knob_rows(ranked) == _knob_rows(jranked)
        for c, jc in zip(ranked, jranked):
            assert set(c.predicted) == set(jc.predicted)
            for k, v in c.predicted.items():
                assert v == pytest.approx(jc.predicted[k], rel=1e-12, abs=0.0), k
            assert c.score == pytest.approx(jc.score, rel=1e-12, abs=0.0)


def test_ranking_deterministic_and_best_first(flat_step_cost):
    """Same seed, same order across exact ties (with the overlap off the
    dispatch batch cannot move the price); prefetch hides the gather, so it
    ranks first."""
    cfg = tiny(refill_overlap="off")
    axes = {"refill_dispatch_batch": (2, 4, 8, 16), "prefetch": (False, True)}

    def order(seed):
        cands, _ = lattice.enumerate_lattice(cfg, axes)
        return _knob_rows(lattice.rank_candidates(cands, "train", 1, seed))

    assert order(0) == order(0) and order(7) == order(7)
    cands, _ = lattice.enumerate_lattice(cfg, axes)
    ranked = lattice.rank_candidates(cands, "train", 1, 0)
    scores = [c.score for c in ranked]
    assert len(ranked) == 8 and scores == sorted(scores, reverse=True)
    assert ranked[0].knobs["prefetch"] is True
    for c in ranked:
        assert c.predicted["score"] == c.score > 0
        assert {"device_ms", "wire_ms", "step_total_ms", "harvest_ms"} <= set(c.predicted)


def test_pricing_failure_drops_the_candidate(monkeypatch, capsys):
    def cost(cand, n_devices):
        if cand.knobs["prefetch"]:
            raise RuntimeError("boom")
        return dict(_FLAT_COST)

    monkeypatch.setattr(lattice, "_step_cost", cost)
    cands, _ = lattice.enumerate_lattice(tiny(), {"prefetch": (False, True)})
    ranked = lattice.rank_candidates(cands)
    assert [c.knobs for c in ranked] == [{"prefetch": False}]
    assert "pricing prefetch=True failed" in capsys.readouterr().err


@pytest.mark.parametrize("kw,n_devices", [
    (dict(), 1), (dict(master_dtype="bf16"), 1), (dict(activation="jumprelu", l1_coeff=0.0,
                                                       l0_coeff=1.0, sparse_bwd="off"), 1),
    (dict(model_axis_size=2), 4), (dict(), 8)])
def test_the_ports_step_cost_counts_o1s_bytes_and_the_policys_model(kw, n_devices):
    """Bytes: each leaf's parameter, gradient and moments read and the
    parameter and moments written once, in its dtype, over the leaves one
    rank holds (the state the trainer builds, split over ``model``);
    operations and wire: the score policy's."""
    cfg = tiny(d_in=16, dict_size=64, **kw)
    cand = lattice.Candidate({}, cfg)
    cost = lattice._step_cost(cand, n_devices)
    state = init_train_state(cfg, Optimizer(cfg, lambda s: 0.0), device="cpu")
    m = cfg.model_axis_size
    split = {"W_enc": m, "W_dec": m, "b_enc": m, "log_theta": m, "b_dec": 1}
    leaf_bytes = sum(v.numel() // split[k] * v.element_size() for k, v in state.params.items())
    assert cost["bytes_accessed"] == 7 * leaf_bytes
    pol = fleet.FleetPolicy(cfg)
    n_data = n_devices // m
    assert cost["flops"] == pol.step_flops(n_data, m)
    assert cost["wire_bytes"] == lattice.comm_model.wire_bytes(pol.step_profile(n_data, m),
                                                              axis_size=n_data)
    assert (cost["wire_bytes"] == 0.0) == (n_data == 1)


def test_the_port_holds_none_of_jaxs_tpu_constants():
    for name in ("PEAK_FLOPS", "HBM_GBPS", "HOST_DISPATCH_MS", "HARVEST_REF_MS"):
        assert getattr(lattice, name) != getattr(jlat, name), name
    assert lattice.PEAK_FLOPS == fleet.PEAK_FLOPS
    assert lattice.WIRE_GBPS == lattice.comm_model.NVLINK_GBPS
    src = "\n".join(p.read_text() for p in (ROOT / "crosscoder_tpu_torch" / "tune").glob("*.py"))
    for literal in ("197e12", "819.0", "= 7.0", "= 85.0"):
        assert literal not in src, literal


# ---------------------------------------------------------------------------
# the search, tune() (stage 2 rigged through the injectable seams)


def _pass_gate(cfg, knobs=None):
    return True, []


def _rigged(mcfg, *, steps, warmup, n_devices):
    won = (mcfg.prefetch, mcfg.refill_frac) == (False, 0.25)
    s = 1e6 if won else 10.0
    return {"score": s, "acts_per_sec_chip": s, "step_ms": 1.0, "bubble_frac": 0.0}


def test_rigged_race_picks_the_planted_winner(flat_step_cost, tmp_path):
    """Stage 2 overrules stage 1: the planted win sits on an assignment the
    model ranks last (prefetch off), and the artifact pins it."""
    out = tmp_path / "TUNED.json"
    reg = MetricsRegistry()
    art = autotune.tune(tiny(), "train", axes={"prefetch": (False, True),
                                               "refill_frac": (0.25, 0.5)},
                        top_k=4, out_path=str(out), registry=reg, measure=_rigged,
                        gate=_pass_gate, device="cpu")
    assert art.knobs == {"prefetch": False, "refill_frac": 0.25}
    assert art.measured["score"] == 1e6
    assert [reg.get_count(f"tune/{k}") for k in ("candidates", "calibrated", "emitted")] == [
        4, 4, 1]
    assert artifact.load_tuned(out).knobs == art.knobs
    assert len(art.search["candidates"]) == 4
    assert all(r["gate"] == "pass" for r in art.search["candidates"])
    assert art.gate["rule_set"] == calibrate.RULE_SET


def test_the_same_rigged_search_gives_jaxs_artifact(flat_step_cost, jax_constants, tmp_path):
    """Both packages' tune() over the same lattice, stubs and seed: the same winner,
    audit, search record, predictions and config hash; only the gate's
    rule set names each package's own gate."""
    axes = {"prefetch": (False, True), "refill_frac": (0.25, 0.5), "refill_dispatch_batch": (4, 8)}

    def gate(cfg, knobs=None):
        if cfg.refill_dispatch_batch == 8 and cfg.prefetch:
            return False, ["seeded violation"]
        return True, []

    reg, jreg = MetricsRegistry(), JRegistry()
    kw = dict(axes=axes, top_k=3, n_devices=1, seed=3, measure=_rigged, gate=gate)
    art = autotune.tune(tiny(), "train", registry=reg, device="cpu", **kw)
    jart_ = jautotune.tune(jtiny(), "train", registry=jreg, **kw)
    d, jd = art.to_dict(), jart_.to_dict()
    assert d["gate"].pop("rule_set") == calibrate.RULE_SET
    jd["gate"].pop("rule_set")
    assert d == jd
    for k in ("candidates", "priced", "calibrated", "rejected_contract", "emitted"):
        assert reg.get_count(f"tune/{k}") == jreg.get_count(f"tune/{k}"), k
    assert reg.get_count("tune/rejected_contract") >= 1


def test_contract_violator_is_discarded_and_counted(flat_step_cost):
    def gate(gcfg, knobs=None):
        if gcfg.prefetch:
            return False, ["tune-data-plane: seeded violation"]
        return True, []

    reg = MetricsRegistry()
    art = autotune.tune(tiny(), "train", axes={"prefetch": (False, True)}, top_k=2,
                        registry=reg, measure=lambda c, **kw: {"score": 100.0}, gate=gate,
                        device="cpu")
    assert art.knobs == {"prefetch": False}
    assert reg.get_count("tune/rejected_contract") == 1
    assert art.gate["rejected"] == 1 and art.gate["checked"] == 2
    rejected = [r for r in art.search["candidates"] if r["gate"] == "rejected"]
    assert [r["knobs"] for r in rejected] == [{"prefetch": True}]
    assert "seeded violation" in rejected[0]["findings"][0]


def test_all_candidates_rejected_refuses_to_emit(flat_step_cost):
    with pytest.raises(ValueError, match="rejected by the step-identity gate"):
        autotune.tune(tiny(), "train", axes={"prefetch": (False, True)},
                      gate=lambda cfg, knobs=None: (False, ["no"]),
                      measure=lambda cfg, **kw: {"score": 1.0}, device="cpu")


def test_empty_lattice_refuses_to_emit(flat_step_cost):
    with pytest.raises(ValueError, match="config validation"):
        autotune.tune(tiny(), "train", axes={"refill_frac": (0.9,)}, device="cpu")


def test_default_knobs_always_calibrated(flat_step_cost):
    seen = []

    def measure(mcfg, *, steps, warmup, n_devices):
        seen.append((mcfg.prefetch, mcfg.refill_frac))
        return {"score": 50.0}

    autotune.tune(tiny(), "train", axes={"prefetch": (False, True), "refill_frac": (0.25, 0.5)},
                  top_k=1, measure=measure, gate=_pass_gate, device="cpu")
    assert (True, 0.5) in seen and len(seen) == 2


def test_n_devices_defaults_to_the_world_size(flat_step_cost):
    art = autotune.tune(tiny(), "train", axes={"prefetch": (False, True)},
                        measure=lambda c, **kw: {"score": 1.0}, gate=_pass_gate, device="cpu")
    assert art.mesh == {"n_devices": 1, "n_model": 1, "n_data": 1}


# ---------------------------------------------------------------------------
# the artifact


def _valid(mod, **kw):
    base = dict(objective="train", knobs={"prefetch": False}, mesh={"n_devices": 1, "n_model": 1})
    base.update(kw)
    return mod.TunedArtifact(**base)


def test_artifact_round_trip_and_jaxs_bytes(tmp_path):
    kw = dict(mesh={"n_devices": 8, "n_model": 2}, measured={"score": 3.5, "scored_on": "wall"},
              predicted={"score": 1.25e3}, search={"axes": {"prefetch": [False, True]}},
              config_hash=artifact.config_hash(tiny()))
    art = _valid(artifact, **kw)
    assert art.topology == "d8m2" == artifact.topology_key(8, 2)
    p = art.save(tmp_path / "TUNED.json")
    jp = _valid(jart, **kw).save(tmp_path / "J.json")
    assert p.read_bytes() == jp.read_bytes()
    got = artifact.load_tuned(p)
    assert (got.knobs, got.measured, got.topology) == (art.knobs, art.measured, "d8m2")
    assert not (tmp_path / "TUNED.json.tmp").exists()


BREAKAGES = [
    lambda d: d.pop("knobs"),
    lambda d: d.update(knobs=[]),
    lambda d: d.update(knobs={}),
    lambda d: d.update(version=99),
]


@pytest.mark.parametrize("breakage", BREAKAGES, ids=["missing", "ill-typed", "empty", "version"])
def test_artifact_validation_rejects_what_jax_rejects(tmp_path, breakage):
    d = _valid(artifact).to_dict()
    breakage(d)
    p = tmp_path / "TUNED.json"
    p.write_text(json.dumps(d, default=str))
    for mod in (artifact, jart):
        with pytest.raises(ValueError):
            mod.load_tuned(p)


@pytest.mark.parametrize("payload", ["", "not json {", "[1, 2]"])
def test_load_tuned_rejects_non_artifacts(tmp_path, payload):
    p = tmp_path / "TUNED.json"
    p.write_text(payload)
    with pytest.raises(ValueError):
        artifact.load_tuned(p)
    with pytest.raises(ValueError):
        artifact.load_tuned(tmp_path / "no_such_file.json")


def _fields(c):
    return {f.name: getattr(c, f.name) for f in dataclasses.fields(c)}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_an_artifact_crosses_between_the_packages(tmp_path, writer):
    """One package writes, the other applies (and itself too): the same
    config, with equal config hashes on both sides."""
    knobs = {"prefetch": False, "refill_frac": 0.25,
             "hook_points": ["blocks.3.hook_resid_pre", "blocks.5.hook_resid_pre"]}
    mod = jart if writer == "jax" else artifact
    p = _valid(mod, knobs=knobs).save(tmp_path / "TUNED.json")
    got = artifact.apply_tuned(tiny(), p)
    jgot = jart.apply_tuned(jtiny(), p)
    assert _fields(got) == _fields(jgot)
    assert got.hook_points == tuple(knobs["hook_points"]) and got.tuned == str(p)
    assert artifact.config_hash(got) == jart.config_hash(jgot)
    assert artifact.config_hash(got) == artifact.config_hash(
        tiny(prefetch=False, refill_frac=0.25, hook_points=tuple(knobs["hook_points"])))


def test_apply_tuned_refuses_what_jax_refuses(tmp_path):
    cfg = tiny()
    assert artifact.apply_tuned(cfg) is cfg
    _valid(artifact, knobs={"no_such_knob": 1}).save(tmp_path / "BAD.json")
    _valid(artifact, knobs={"refill_frac": 0.9}).save(tmp_path / "STALE.json")
    for name, match in (("BAD.json", "unknown knob"), ("STALE.json", "refill_frac")):
        for mod, c in ((artifact, cfg), (jart, jtiny())):
            with pytest.raises(ValueError, match=match):
                mod.apply_tuned(c, tmp_path / name)


def test_default_config_hash_is_jaxs():
    assert artifact.config_hash(CrossCoderConfig()) == jart.config_hash(JCfg())


# ---------------------------------------------------------------------------
# the re-tune at a re-mesh, the fleet policy, the CLI


def test_on_remesh_lifecycle_is_jaxs(tmp_path, capsys):
    cfg, jcfg = tiny(), jtiny()
    assert artifact.on_remesh(cfg, 2) == (cfg, "off")
    p = _valid(artifact, knobs={"refill_frac": 0.5}).save(tmp_path / "TUNED.json")
    cfg, jcfg = artifact.apply_tuned(cfg, p), jart.apply_tuned(jcfg, p)

    def both(n):
        got, status = artifact.on_remesh(cfg, n)
        jgot, jstatus = jart.on_remesh(jcfg, n)
        assert status == jstatus and _fields(got) == _fields(jgot)
        return got, status

    assert both(1)[1] == "current"
    got, status = both(4)
    assert status == "stale" and got.refill_frac == 0.5
    _valid(artifact, knobs={"refill_frac": 0.25}, mesh={"n_devices": 4, "n_model": 1}).save(
        artifact.cache_path(tmp_path, "d4m1"))
    got, status = both(4)
    assert status == "cache_hit" and got.refill_frac == 0.25
    artifact.cache_path(tmp_path, "d2m1").write_text("torn{")
    got, status = both(2)
    assert status == "stale" and got.refill_frac == 0.5
    assert "ignoring malformed cached artifact" in capsys.readouterr().err


@pytest.mark.parametrize("policy", ["fixed", "score"])
def test_fleet_policy_takes_the_tuned_grid_as_jax(tmp_path, policy):
    p = _valid(artifact, mesh={"n_devices": 4, "n_model": 2}).save(
        artifact.cache_path(tmp_path, "d4m2"))
    pinned = _valid(artifact, mesh={"n_devices": 2, "n_model": 1}).save(tmp_path / "TUNED.json")
    for tuned in (str(tmp_path / "nope.json"), str(pinned)):
        kw = dict(elastic_policy=policy, tuned=tuned)
        pol, jpol = fleet.FleetPolicy(tiny(**kw)), jfleet.FleetPolicy(jtiny(**kw))
        for n in (1, 2, 4, 8):
            c, jc = pol.choose(n), jpol._tuned_choice(n)
            if jc is None:          # the base policy's (held to JAX's elsewhere)
                assert c.detail["policy"] == policy
            else:
                assert (c.n_data, c.n_model, c.score_ms, c.detail) == (
                    jc.n_data, jc.n_model, jc.score_ms, jc.detail)
        choice = pol.choose(4)
        assert (choice.n_data, choice.n_model) == (2, 2)
        assert choice.detail == {"policy": "tuned", "artifact": str(p), "objective": "train"}
        assert (pol.choose(2).detail["policy"] == "tuned") == (tuned == str(pinned))


def test_from_cli_tuned_resolution_order_is_jaxs(tmp_path):
    p = _valid(artifact, knobs={"refill_frac": 0.25, "prefetch": False}).save(
        tmp_path / "TUNED.json")
    cj = tmp_path / "cfg.json"
    cj.write_text(json.dumps({"refill_frac": 0.5, "d_in": 16}))
    argv = ["--config-json", str(cj), "--tuned", str(p), "--prefetch", "true"]
    cfg = CrossCoderConfig.from_cli(argv)
    assert _fields(cfg) == _fields(JCfg.from_cli(argv))
    assert (cfg.refill_frac, cfg.prefetch, cfg.d_in) == (0.25, True, 16)
    cj.write_text(json.dumps({"tuned": str(p)}))
    for argv in (["--config-json", str(cj), "--tuned", ""], ["--config-json", str(cj)]):
        cfg = CrossCoderConfig.from_cli(argv)
        assert _fields(cfg) == _fields(JCfg.from_cli(argv))
    assert cfg.tuned == str(p) and cfg.refill_frac == 0.25
    assert CrossCoderConfig.from_cli(["--config-json", str(cj), "--tuned", ""]).refill_frac == 0.5


# ---------------------------------------------------------------------------
# the report


def _report_art(mod):
    return _valid(
        mod, predicted={"score": 123.4}, measured={"score": 117.0, "scored_on": "wall"},
        gate={"rule_set": calibrate.RULE_SET, "checked": 3, "rejected": 1},
        search={"axes": {"prefetch": [False, True]}, "n_candidates": 2, "n_pruned_invalid": 0,
                "n_priced": 2, "top_k": 2, "seed": 0, "calibration_steps": 6,
                "candidates": [
                    {"knobs": {"prefetch": False}, "gate": "pass", "predicted_score": 123.4,
                     "measured_score": 117.0},
                    {"knobs": {"prefetch": True}, "gate": "rejected"}]})


def test_report_renders_as_the_jax_script(tmp_path, capsys):
    p = _report_art(artifact).save(tmp_path / "TUNED.json")
    script = _load_script("tune_report")
    assert report.render(artifact.load_tuned(p)) == script.render(jart.load_tuned(p))
    for argv in ([str(p)], [str(p), "--json"]):
        assert script.main(argv) == 0
        want = capsys.readouterr().out
        assert report.main(argv) == 0
        assert capsys.readouterr().out == want
    assert json.loads(want)["knobs"] == {"prefetch": False}
    assert "d1m1" in report.render(artifact.load_tuned(p))


@pytest.mark.parametrize("payload", [
    "", "not json", json.dumps({"version": 1}),
    json.dumps({**_valid(jart).to_dict(), "knobs": {}}, default=str)])
def test_report_rejects_what_the_jax_script_rejects(tmp_path, payload, capsys):
    p = tmp_path / "TUNED.json"
    p.write_text(payload)
    assert _load_script("tune_report").main([str(p)]) == 2
    assert report.main([str(p)]) == 2
    assert "MALFORMED ARTIFACT" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the gate and the window on the CPU


def test_gate_passes_a_data_plane_candidate():
    knobs = {"refill_frac": 0.25, "prefetch": False, "refill_overlap": "on"}
    cfg = tiny(activation="topk", topk_k=4, l1_coeff=0.0, sparse_bwd="on", aux_k=8, **knobs)
    ok, findings = calibrate.step_identity_gate(cfg, knobs=knobs, device="cpu")
    assert ok, findings
    assert calibrate._step_projection_cfg(cfg, knobs).refill_overlap == "off"


def test_gate_rejects_a_step_knob_smuggled_past_step_fields(monkeypatch):
    monkeypatch.setattr(lattice, "STEP_FIELDS", lattice.STEP_FIELDS - {"topk_k"})
    cfg = tiny(activation="topk", topk_k=4, l1_coeff=0.0)
    ok, findings = calibrate.step_identity_gate(cfg, knobs={"topk_k": 4}, device="cpu")
    assert not ok
    assert any("loss" in f for f in findings) and any("params[W_enc]" in f for f in findings)
    # through tune(): discarded and counted; the default k passes
    reg = MetricsRegistry()
    art = autotune.tune(cfg.replace(topk_k=32), "train", axes={"topk_k": (4, 32)}, top_k=2,
                        registry=reg, measure=lambda c, **kw: {"score": 1.0}, device="cpu")
    assert reg.get_count("tune/rejected_contract") == 1 and art.knobs == {"topk_k": 32}


def test_gate_rejects_a_smuggled_knob_that_reaches_only_the_state(monkeypatch):
    monkeypatch.setattr(lattice, "STEP_FIELDS", lattice.STEP_FIELDS - {"dict_size"})
    ok, findings = calibrate.step_identity_gate(tiny(dict_size=64), knobs={"dict_size": 64},
                                                device="cpu")
    assert not ok and "tune-data-plane: params[W_enc] differs from the projection's step" \
        in findings


def test_gate_turns_a_crashed_harness_into_a_finding(monkeypatch):
    def boom(cfg, dev):
        raise RuntimeError("the harness broke")

    monkeypatch.setattr(calibrate, "_one_step", boom)
    ok, findings = calibrate.step_identity_gate(tiny(), knobs={"prefetch": False}, device="cpu")
    assert not ok and findings == ["tune-gate-harness: RuntimeError: the harness broke"]


def test_measure_window_on_the_cpu_returns_jaxs_keys():
    jm = jcal.measure_window(jtiny(), steps=1, warmup=1)
    m = calibrate.measure_window(tiny(), steps=2, warmup=1, device="cpu")
    assert set(jm) <= set(m)
    assert set(m) - set(jm) == {"wall_step_ms", "scored_on"}
    assert m["steps"] == 2.0 and 0.0 <= m["bubble_frac"] <= 0.95
    assert m["score"] == m["acts_per_sec_chip"] == pytest.approx(
        32 * 1e3 / m["effective_step_ms"])
    if m["scored_on"] == "span":
        assert m["effective_step_ms"] == pytest.approx(m["step_ms"] / (1 - m["bubble_frac"]))
    else:
        assert m["effective_step_ms"] == m["wall_step_ms"] == pytest.approx(
            1e3 * m["wall_s"] / 2)


def test_smoke_module_exits_0_on_the_cpu(tmp_path):
    r = subprocess.run([sys.executable, "-m", "crosscoder_tpu_torch.tune.smoke", "--device", "cpu"],
                       cwd=ROOT, capture_output=True, text=True, timeout=240,
                       env={**os.environ, "TUNE_SMOKE_DIR": str(tmp_path)})
    assert r.returncode == 0, r.stderr[-2000:]
    assert "tune smoke: OK" in r.stderr
    art = artifact.load_tuned(tmp_path / "TUNED.json")
    assert art.search["n_candidates"] == 8 and art.gate["rejected"] == 0


def test_every_entry_point_asks_for_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("TUNE_SMOKE_DIR", str(tmp_path))
    for call in (lambda: autotune.tune(tiny(), axes={"prefetch": (False, True)},
                                       measure=lambda c, **kw: {"score": 1.0},
                                       gate=_pass_gate),
                 lambda: calibrate.measure_window(tiny()),
                 lambda: calibrate.step_identity_gate(tiny(), {}),
                 lambda: smoke.main([])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# ---------------------------------------------------------------------------
# --tuned through the CLI entry point


def _argv(tmp_path, tag, extra=()):
    return ["--data-source", "synthetic", "--batch-size", "64", "--buffer-mult", "4",
            "--num-tokens", "1920", "--d-in", "16", "--dict-size", "256", "--seq-len", "17",
            "--log-backend", "jsonl", "--log-every", "10", "--save-every", "10000",
            "--checkpoint-dir", str(tmp_path / f"ckpt_{tag}"), *extra]


def test_tuned_flag_round_trips_bitwise_through_main(tmp_path, capsys):
    """``--tuned TUNED.json`` resolves to the config, and the loss
    trajectory bit for bit, of the artifact's knobs passed as flags."""
    from crosscoder_tpu_torch.train.main import main

    p = _valid(artifact, knobs={"refill_frac": 0.25, "prefetch": False}).save(
        tmp_path / "TUNED.json")
    t_tuned = main(_argv(tmp_path, "tuned", ["--tuned", str(p)]), device="cpu")
    assert f"running with pinned artifact {p}" in capsys.readouterr().err
    t_hand = main(_argv(tmp_path, "hand", ["--refill-frac", "0.25", "--prefetch", "false"]),
                  device="cpu")
    da, db = t_tuned.cfg.to_dict(), t_hand.cfg.to_dict()
    for d in (da, db):
        d.pop("tuned"), d.pop("checkpoint_dir")
    assert da == db and t_tuned.cfg.tuned == str(p)
    rows = [[json.loads(ln) for ln in (tmp_path / f"ckpt_{t}" / "metrics.jsonl").read_text()
             .splitlines()] for t in ("tuned", "hand")]
    assert [r["loss"] for r in rows[0]] == [r["loss"] for r in rows[1]]
    assert len(rows[0]) >= 2 and t_tuned.step_counter == t_hand.step_counter == 30
    for k in t_tuned.state.params:
        assert torch.equal(t_tuned.state.params[k], t_hand.state.params[k])
