"""The port's fleet (``crosscoder_tpu_torch/train/fleet.py``,
``models/stacked.py``, the fan-out of ``data/fanout.py``) on the CPU, at
the shapes of ``tests/test_fleet.py`` (``d_in`` 16, dict 64):

- every tenant, of a cohort or a bucket, admitted at the start or mid-run,
  BITWISE the port's own solo ``Trainer`` of its config over the same
  stream (losses, params, Adam moments, AuxK state);
- the fleet against the JAX package's ``FleetScheduler`` from the same
  initial states over the same stream, at the mesh trainer's bar of
  ``tests/test_torch_mesh_rest.py``: losses and final params within rtol
  2e-4 / atol 2e-5;
- the fan-out: one real gather a round on the replay buffer (bf16 and
  int8 stores), each consumer the solo stream byte for byte, lockstep
  enforced, cursors through ``state_dict``, a consumer attached mid-stream;
- admission, retirement, the bucket cap, ``save_all``/``restore_all``
  after a preemption (bitwise, and a tenant's save read by the JAX
  ``Checkpointer(tenant=)``), the spec parser and grouping against JAX's,
  the fleet knobs' validation against JAX's, O1's ``[N]`` norm vector
  against N solo calls, and ``train.main --fleet on``.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax

from crosscoder_tpu.checkpoint import Checkpointer as JCheckpointer
from crosscoder_tpu.config import CrossCoderConfig as JCfg
from crosscoder_tpu.models import stacked as jstacked
from crosscoder_tpu.ops import fused_encoder_topk as jfek
from crosscoder_tpu.ops import sparse_grad as jsg
from crosscoder_tpu.ops import topk_pallas as jtp
from crosscoder_tpu.train import fleet as jfleet
from crosscoder_tpu.train.state import make_optimizer as jmake_optimizer
from crosscoder_tpu.train import schedules as jschedules
from crosscoder_tpu_torch import convert
from crosscoder_tpu_torch.checkpoint import Checkpointer
from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.data import buffer as buf
from crosscoder_tpu_torch.data import hostops
from crosscoder_tpu_torch.data.synthetic import SyntheticActivationSource
from crosscoder_tpu_torch.models import lm, stacked
from crosscoder_tpu_torch.obs.registry import MetricsRegistry
from crosscoder_tpu_torch.ops import adam
from crosscoder_tpu_torch.train import main as tmain
from crosscoder_tpu_torch.train.fleet import (FleetScheduler, TenantSpec, parse_tenants,
                                              stack_signature, tenant_config)
from crosscoder_tpu_torch.train.state import Optimizer
from crosscoder_tpu_torch.train.trainer import Trainer

RTOL, ATOL = 2e-4, 2e-5
BASE = dict(d_in=16, dict_size=64, batch_size=64, num_tokens=64 * 1000, enc_dtype="fp32",
            log_backend="null", seed=11)
_TOPK = "activation=topk,topk_k=4,aux_k=8,aux_dead_steps=2,resample_every=3"
# cohort C: TopK tenants that differ in seed and l1_coeff (two take the
# sparse tier at l1 0, one the dense tier), each with AuxK and resampling
# of its own; bucket w: a wider ReLU dictionary
SPEC = (f"c1:seed=1,l1_coeff=0,{_TOPK};c2:seed=2,l1_coeff=0,{_TOPK};"
        f"c3:seed=3,l1_coeff=0.001,{_TOPK};w:seed=1,dict_size=128")
# admitted at round 2, retired after round 6, as chip_smoke.py's phase 14
LATE = TenantSpec("bt", {"seed": 5, "activation": "batchtopk", "topk_k": 4, "dict_size": 32,
                         "l1_coeff": 0.0})
ROUNDS = 8


def base_cfg(**kw):
    return CrossCoderConfig(**{**BASE, **kw})


def fleet_cfg(tenants, **kw):
    return base_cfg(fleet="on", fleet_tenants=tenants, **kw)


def solo(overrides, n_steps, skip_rounds=0):
    """A solo Trainer of a tenant's config over the fleet's stream (the
    base-seed synthetic source) after ``skip_rounds`` serves: its losses
    and the trainer."""
    base = base_cfg()
    src = SyntheticActivationSource(base)
    for _ in range(skip_rounds):
        src.next()
    tr = Trainer(dataclasses.replace(base, **overrides), src, device="cpu")
    return [float(tr.step()["loss"]) for _ in range(n_steps)], tr


def rounds(fl, n):
    out: dict[str, list[float]] = {}
    for _ in range(n):
        for name, md in fl.step_all().items():
            out.setdefault(name, []).append(float(md["loss"]))
    return out


def _states_equal(a, b):
    pairs = [(a.params, b.params), (a.opt_state.mu, b.opt_state.mu),
             (a.opt_state.nu, b.opt_state.nu), (a.aux or {}, b.aux or {})]
    for x, y in pairs:
        assert sorted(x) == sorted(y)
        for k in x:
            assert torch.equal(x[k], y[k]), k
    assert (a.step, a.opt_state.count) == (b.step, b.opt_state.count)


# ---------------------------------------------------------------------------
# every tenant bitwise its solo Trainer


@pytest.fixture(scope="module")
def churn():
    """The fleet of SPEC with LATE admitted at round 2 and retired after
    round 6: per-tenant losses and final states, and the registry."""
    reg = MetricsRegistry()
    fl = FleetScheduler(fleet_cfg(SPEC), checkpoint=False, registry=reg, device="cpu")
    assert [len(c.members) for c in fl._cohorts] == [3] and len(fl._buckets) == 1
    got = rounds(fl, 2)
    fl.admit(LATE)
    for name, ls in rounds(fl, 4).items():
        got.setdefault(name, []).extend(ls)
    late = fl.tenant_state(LATE.name)
    fl.retire(LATE.name, save=False)
    for name, ls in rounds(fl, ROUNDS - 6).items():
        got[name].extend(ls)
    states = {n: fl.tenant_state(n) for n in fl.active()}
    states[LATE.name] = late
    return got, states, reg


@pytest.mark.parametrize("name", ["c1", "c2", "c3", "w", "bt"])
def test_every_tenant_is_bitwise_its_solo_trainer(churn, name):
    got, states, _ = churn
    specs = {s.name: s for s in parse_tenants(SPEC)}
    if name == "bt":
        want, tr = solo(LATE.overrides, 4, skip_rounds=2)
    else:
        want, tr = solo(specs[name].overrides, ROUNDS)
    assert got[name] == want
    _states_equal(states[name], tr.state)


def test_churn_counts_admissions_retirements_and_one_h2d_a_round(churn):
    _, _, reg = churn
    assert reg.get_count("tenant/admissions") == 5
    assert reg.get_count("tenant/retirements") == 1
    assert reg.get_count("comm/h2d_transfers") == ROUNDS


def test_trainer_refuses_the_fleet_naming_the_scheduler():
    with pytest.raises(ValueError, match="FleetScheduler"):
        Trainer(fleet_cfg("a"), device="cpu")


# ---------------------------------------------------------------------------
# against JAX's FleetScheduler


def _fleets_from_the_same_states(spec, **kw):
    """The JAX ``FleetScheduler`` over ``spec`` and the port's, whose
    tenants start from the JAX tenants' initial states."""
    jfl = jfleet.FleetScheduler(JCfg(**{**BASE, **kw}, fleet="on", fleet_tenants=spec),
                                checkpoint=False)
    states = {}
    for co in jfl._cohorts:
        for i, m in enumerate(co.members):
            states[m.name] = jstacked.unstack_state(co.state, i)
    for b in jfl._buckets:
        states[b.tenant.name] = b.state
    states = {n: convert.train_state_from_numpy(jax.device_get(s), device="cpu")
              for n, s in states.items()}
    fl = FleetScheduler(fleet_cfg(spec, **kw), checkpoint=False, device="cpu")
    for co in fl._cohorts:
        co.state = stacked.stack_states([states[m.name] for m in co.members])
    for b in fl._buckets:
        b.state = states[b.tenant.name]
    return jfl, fl


def _held_against_jax(jfl, fl, n_rounds):
    """``n_rounds`` of both fleets: every tenant's losses and final params
    within the bar, its AuxK counters equal."""
    want = {}
    for _ in range(n_rounds):
        for name, md in jfl.step_all().items():
            want.setdefault(name, []).append(float(jax.device_get(md["loss"])))
    got = rounds(fl, n_rounds)
    assert sorted(got) == sorted(want) == sorted(fl.active())
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=RTOL, atol=ATOL, err_msg=name)
    jstates = {b.tenant.name: b.state for b in jfl._buckets}
    for co in jfl._cohorts:
        for i, m in enumerate(co.members):
            jstates[m.name] = jstacked.unstack_state(co.state, i)
    for name, js in jstates.items():
        js = jax.device_get(js)
        st = fl.tenant_state(name)
        for k, v in st.params.items():
            np.testing.assert_allclose(v.numpy(), js.params[k], rtol=RTOL, atol=ATOL,
                                       err_msg=f"{name} {k}")
        if "steps_since_fired" in (st.aux or {}):
            np.testing.assert_array_equal(st.aux["steps_since_fired"].numpy(),
                                          js.aux["steps_since_fired"], err_msg=name)


def test_fleet_matches_the_jax_fleet_from_the_same_states():
    jfl, fl = _fleets_from_the_same_states(
        "a:seed=1;b:seed=2,l1_coeff=0.05;w:seed=1,dict_size=128")
    assert [len(c.members) for c in fl._cohorts] == [2] and len(fl._buckets) == 1
    _held_against_jax(jfl, fl, 5)


# a TopK cohort with AuxK whose members differ in seed and l1_coeff (no
# resampling: the JAX fleet's step has none), and a BatchTopK bucket
_TOPK_J = ("activation=topk,topk_k=4,aux_k=8,aux_dead_steps=2,resample_every=0,"
           "aux_exact_rank=true")
SPEC_J = (f"t1:seed=1,l1_coeff=0.001,{_TOPK_J};t2:seed=2,l1_coeff=0.5,{_TOPK_J};"
          "bt:seed=5,activation=batchtopk,topk_k=4,dict_size=32,l1_coeff=0")


def test_topk_auxk_cohort_and_batchtopk_bucket_match_the_jax_fleet_one_tenant_clipped(
        monkeypatch):
    """``grad_clip`` 4.3 sits between the cohort's two global norms in
    some round (about 4.36 and 4.27 in the second), so one member clips
    and the other does not in the same O1 launch."""
    norms = []
    real = Optimizer.update

    def update(self, *a, norm=None, **k):
        if norm is not None and norm.ndim == 1:
            norms.append(norm.clone())
        return real(self, *a, norm=norm, **k)

    monkeypatch.setattr(Optimizer, "update", update)
    for m in (jtp, jsg, jfek):
        monkeypatch.setattr(m, "_INTERPRET", True)
    jfl, fl = _fleets_from_the_same_states(SPEC_J, grad_clip=4.3, num_tokens=64 * 40)
    assert [len(c.members) for c in fl._cohorts] == [2] and len(fl._buckets) == 1
    _held_against_jax(jfl, fl, 5)
    clip = fl.cfg.grad_clip
    assert any(bool((n > clip).any() and (n < clip).any()) for n in norms), norms
    assert any(float(x) > 0 for x in fl.tenant_state("t1").aux["steps_since_fired"])


@pytest.mark.parametrize("spec", ["a:seed=1,l1_coeff=0.02; b", "x;y:dict_size=128,seed=4",
                                  "p:activation=topk,topk_k=4,l1_coeff=0,sparse_bwd=on;"
                                  "q:activation=topk,topk_k=4,l1_coeff=0,sparse_bwd=on,seed=9"])
def test_parse_group_and_signature_equal_jax(spec):
    specs, jspecs = parse_tenants(spec), jfleet.parse_tenants(spec)
    assert [(s.name, s.overrides) for s in specs] == [(s.name, s.overrides) for s in jspecs]
    base, jbase = fleet_cfg(spec), JCfg(**BASE, fleet="on", fleet_tenants=spec)
    for s, js in zip(specs, jspecs):
        cfg, jcfg = tenant_config(base, s), jfleet.tenant_config(jbase, js)
        assert json.loads(cfg.to_json_str()) == json.loads(jcfg.to_json_str())
        assert stack_signature(cfg) == jfleet.stack_signature(jcfg)


@pytest.mark.parametrize("spec,overrides,match", [
    ("a;a", None, "duplicate tenant"),
    ("a/b", None, "invalid tenant name"),
    (":seed=1", None, "invalid tenant name"),
    ("a:seed", None, "malformed override"),
    ("a", {"batch_size": 32}, "pinned"),
    ("a", {"num_tokens": 64}, "pinned"),
    ("a", {"quant_grads": True}, "quant_grads"),
])
def test_spec_errors_equal_jax(spec, overrides, match):
    def errors(parse, config, make_cfg):
        with pytest.raises(ValueError, match=match) as e:
            specs = parse(spec)
            config(make_cfg(), type(specs[0])("x", overrides))
        return str(e.value)

    port = errors(parse_tenants, tenant_config, lambda: fleet_cfg("a"))
    jax_ = errors(jfleet.parse_tenants, jfleet.tenant_config,
                  lambda: JCfg(**BASE, fleet="on", fleet_tenants="a"))
    assert port == jax_


@pytest.mark.parametrize("kw", [dict(fleet="off", fleet_tenants="a:seed=1"),
                                dict(fleet="on", fleet_max_buckets=0),
                                dict(fleet="on", quant_grads=True),
                                dict(fleet="sometimes")])
def test_fleet_knobs_raise_the_jax_errors(kw):
    with pytest.raises(ValueError) as want:
        JCfg(**BASE, **kw)
    with pytest.raises(ValueError) as got:
        base_cfg(**kw)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the fan-out


SEQ = 17


@pytest.fixture(scope="module")
def lm_pair():
    return lm.LMConfig.tiny(), [lm.init_params(lm.LMConfig.tiny(), seed=s, device="cpu")
                                for s in (0, 1)]


def _buf_cfg(**kw):
    return CrossCoderConfig(**{**dict(batch_size=32, buffer_mult=32, seq_len=SEQ, d_in=32,
                                      n_models=2, model_batch_size=4, norm_calib_batches=2,
                                      hook_point="blocks.2.hook_resid_pre", seed=3,
                                      quant_block=16), **kw})


@pytest.mark.parametrize("quant_buffer", [False, True], ids=["bf16", "int8"])
def test_fanout_gathers_once_a_position_and_serves_the_solo_stream(lm_pair, quant_buffer,
                                                                   monkeypatch):
    """Three consumers over 6 rounds (a refill cycle ends inside them)
    gather as often as one solo consumer, the peers get the same tensor,
    and every consumer's stream is the solo stream byte for byte; a fourth
    attached at round 3 starts at the live head."""
    lm_cfg, params = lm_pair
    tokens = np.random.default_rng(7).integers(0, 257, size=(256, SEQ), dtype=np.int64)
    gathers = []
    real = hostops.gather_rows
    monkeypatch.setattr(hostops, "gather_rows",
                        lambda *a, **k: (gathers.append(1), real(*a, **k))[1])

    def run(consumers):
        gathers.clear()
        b = buf.make_buffer(_buf_cfg(quant_buffer=quant_buffer), lm_cfg, params, tokens,
                            device="cpu")
        for n in consumers:
            assert b.attach_consumer(n) == 0
        served, late = [], []
        for r in range(6):
            if r == 3 and consumers:
                assert b.attach_consumer("late") == 3
            if consumers:
                names = consumers + (["late"] if r >= 3 else [])
                batches = [b.next_raw_for(n) for n in names]
                assert all(x is batches[0] for x in batches[1:])
                served.append(batches[0].clone())
            else:
                served.append(b.next_raw().clone())
        return len(gathers), served, b

    n_solo, solo_stream, _ = run([])
    n_fan, fan_stream, b = run(["a", "b", "c"])
    assert n_fan == n_solo > 0
    for x, y in zip(fan_stream, solo_stream):
        assert torch.equal(x.view(torch.int16), y.view(torch.int16))
    assert {n: b.consumer_cursor(n) for n in ("a", "b", "c", "late")} == \
        {"a": 6, "b": 6, "c": 6, "late": 6}
    assert b.state_dict()["consumers"] == {"a": 0, "b": 0, "c": 0, "late": 0}


def test_fanout_lockstep_enforced_and_every_store_has_it():
    src = SyntheticActivationSource(base_cfg())
    src.attach_consumer("fast")
    src.attach_consumer("slow")
    src.next_for("fast")
    src.next_for("slow")
    src.next_for("fast")
    src.next_for("fast")
    with pytest.raises(RuntimeError, match="lockstep"):
        src.next_for("slow")
    with pytest.raises(ValueError, match="already attached"):
        src.attach_consumer("fast")
    for cls in (buf.PairedActivationBuffer, buf.QuantPairedActivationBuffer,
                buf.MeshPairedActivationBuffer, buf.QuantMeshPairedActivationBuffer):
        assert cls.next_raw_for is buf.PairedActivationBuffer.next_raw_for


def test_cursors_through_state_dict():
    cfg = base_cfg()
    src = SyntheticActivationSource(cfg)
    for n in ("a", "b"):
        src.attach_consumer(n)
    for _ in range(3):
        src.next_for("a")
        src.next_for("b")
    src.next_for("a")                            # mid-round: b one behind
    mid = src.state_dict()
    assert mid == {"counter": 4, "consumers": {"a": 0, "b": 1}}
    src.next_for("b")
    saved = src.state_dict()
    assert saved == {"counter": 4, "consumers": {"a": 0, "b": 0}}
    want = src.next_for("a")
    again = SyntheticActivationSource(cfg)
    for n in ("a", "b"):
        again.attach_consumer(n)
    with pytest.raises(ValueError, match="mid-round"):
        again.load_state_dict(mid)
    again.load_state_dict(saved)
    assert again.consumer_cursor("a") == again.consumer_cursor("b") == 4
    np.testing.assert_array_equal(again.next_for("b"), want)
    assert SyntheticActivationSource(cfg).state_dict() == {"counter": 0}    # solo: JAX's form


# ---------------------------------------------------------------------------
# admission, retirement, the bucket cap


def test_admission_and_retirement_mid_run():
    reg = MetricsRegistry()
    fl = FleetScheduler(fleet_cfg("a:seed=1;b:seed=2"), checkpoint=False, registry=reg,
                        device="cpu")
    traj = rounds(fl, 3)
    fl.admit(TenantSpec("late", {"seed": 7, "dict_size": 128}))
    assert "late" in fl.active() and len(fl._buckets) == 1
    mid = rounds(fl, 3)
    assert mid["late"] == solo(dict(seed=7, dict_size=128), 3, skip_rounds=3)[0]
    fl.retire("b", save=False)
    assert fl.active() == ["a", "late"]
    assert len(fl._cohorts[0].members) == 1
    tail = rounds(fl, 3)
    assert "b" not in tail
    assert traj["a"] + mid["a"] + tail["a"] == solo(dict(seed=1), 9)[0]
    assert reg.get_count("tenant/admissions") == 3
    assert reg.get_count("tenant/retirements") == 1


def test_bucket_cap_rejects_then_frees():
    fl = FleetScheduler(fleet_cfg("a:seed=1,dict_size=128", fleet_max_buckets=1),
                        checkpoint=False, device="cpu")
    with pytest.raises(ValueError, match="fleet_max_buckets"):
        fl.admit(TenantSpec("b", {"dict_size": 96}))
    assert fl.active() == ["a"]
    fl.retire("a", save=False)
    fl.admit(TenantSpec("b", {"dict_size": 96}))
    assert fl.active() == ["b"]


def test_a_mesh_and_remesh_are_refused():
    # the fleet takes a rank grid (tests/test_torch_fleet_mesh.py); one
    # wider than the ranks present is refused as the Trainer refuses it
    with pytest.raises(ValueError, match="must divide device count 1"):
        FleetScheduler(fleet_cfg("a", model_axis_size=2), checkpoint=False, device="cpu")
    # the re-mesh onto another grid is ported: tests/test_torch_elastic_regrow.py


# ---------------------------------------------------------------------------
# save_all / restore_all


def test_restore_all_after_preemption_continues_bitwise(tmp_path):
    spec = "a:seed=1;b:seed=2,l1_coeff=0.05;w:seed=3,dict_size=128"
    ref_fl = FleetScheduler(fleet_cfg(spec), checkpoint=False, device="cpu")
    ref = rounds(ref_fl, 8)
    fl = FleetScheduler(fleet_cfg(spec, checkpoint_dir=str(tmp_path)), device="cpu")
    head = rounds(fl, 4)
    fl.save_all(background=True)
    fl.quiesce()
    del fl                                      # the preemption
    fl2 = FleetScheduler(fleet_cfg(spec, checkpoint_dir=str(tmp_path)), device="cpu")
    assert fl2.restore_all() == {"a": 4, "b": 4, "w": 4}
    assert fl2.buffer.counter == 4
    tail = rounds(fl2, 4)
    for name in ("a", "b", "w"):
        assert head[name] == ref[name][:4], name
        assert tail[name] == ref[name][4:], name
        _states_equal(fl2.tenant_state(name), ref_fl.tenant_state(name))
    # a tenant's save under tenants/<name>/ restores in the JAX Checkpointer
    jcfg = JCfg(**{**BASE, "seed": 2, "l1_coeff": 0.05})
    jstate, meta = JCheckpointer(str(tmp_path), cfg=jcfg, tenant="b").restore(
        jcfg, jmake_optimizer(jcfg, jschedules.lr_schedule(jcfg)))
    assert int(meta["step"]) == 4 and meta["buffer"]["counter"] == 4
    b4 = FleetScheduler(fleet_cfg(spec, checkpoint_dir=str(tmp_path)), device="cpu")
    b4.restore_all()
    for k, v in b4.tenant_state("b").params.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jstate.params[k]), err_msg=k)


def test_tenant_saves_hold_solo_configs_and_restore_checks_them(tmp_path):
    fl = FleetScheduler(fleet_cfg("a:seed=1;w:dict_size=128", checkpoint_dir=str(tmp_path),
                                  keep_saves=2), device="cpu")
    for _ in range(3):
        fl.step_all()
        fl.save_all()
    vdir = Checkpointer.latest_version_dir(tmp_path / "tenants" / "w")
    assert Checkpointer.complete_saves(vdir) == [1, 2]        # kept per tenant
    saved = CrossCoderConfig.from_json(vdir / "2_cfg.json")
    assert (saved.fleet, saved.fleet_tenants, saved.dict_size) == ("off", "", 128)
    assert saved == tenant_config(fl.cfg, TenantSpec("w", {"dict_size": 128}))
    other = FleetScheduler(fleet_cfg("a:seed=1;w:dict_size=96", checkpoint_dir=str(tmp_path)),
                           device="cpu")
    with pytest.raises(ValueError, match="shape"):
        other.restore_all()
    with pytest.raises(ValueError, match="invalid tenant name"):
        Checkpointer(tmp_path, tenant="..")


# ---------------------------------------------------------------------------
# O1 with a norm vector


@pytest.mark.parametrize("master", ["f32", "bf16_mixed"])
def test_adam_plain_norm_vector_is_bitwise_per_tenant_calls(master):
    """Three tenants' leaves stacked; tenant 1's norm clips (above
    max_norm 1), tenants 0 and 2 do not: the one call with the [3] norms
    equals three solo calls bitwise."""
    g = torch.Generator().manual_seed(0)
    dt = torch.float32 if master == "f32" else torch.bfloat16
    shapes = {"W_enc": (3, 2, 8, 16), "b_dec": (3, 2, 8), "log_theta": (3, 16)}

    def leaf(k, scale=1.0):
        t = torch.randn(shapes[k], generator=g) * scale
        return t.to(torch.float32 if k == "log_theta" else dt)

    p, gr = {k: leaf(k) for k in shapes}, {k: leaf(k, 0.3) for k in shapes}
    mu, nu = {k: leaf(k, 0.01) for k in shapes}, {k: leaf(k, 0.01).abs() for k in shapes}
    norms = torch.tensor([0.5, 3.0, 0.999], dtype=torch.float32)
    kw = dict(max_norm=1.0, b1=0.9, b2=0.999, eps=1e-8, bc1=0.19, bc2=0.002997,
              step_size=-1e-3)
    out = tuple({k: torch.empty_like(v) for k, v in d.items()} for d in (p, mu, nu))
    adam.adam_update(p, gr, mu, nu, norms, out=out, **kw)
    for t in range(3):
        sl = [{k: v[t].clone() for k, v in d.items()} for d in (p, gr, mu, nu)]
        adam.adam_update_plain(*sl, norms[t], **kw)
        for d_out, d_want in zip(out, (sl[0], sl[2], sl[3])):
            for k in shapes:
                assert torch.equal(d_out[k][t], d_want[k]), (t, k)
    with pytest.raises(ValueError, match="tenant axis"):
        adam.adam_update_plain({"x": torch.zeros(2, 4)}, {"x": torch.zeros(2, 4)},
                               {"x": torch.zeros(2, 4)}, {"x": torch.zeros(2, 4)}, norms, **kw)


# ---------------------------------------------------------------------------
# the CLI


def test_main_fleet_on_trains_saves_and_resumes(tmp_path):
    argv = ["--data-source", "synthetic", "--d-in", "16", "--dict-size", "64", "--batch-size",
            "16", "--num-tokens", "64", "--fleet", "on", "--fleet-tenants",
            "a:seed=1;b:seed=2,l1_coeff=0.5;w:dict_size=32", "--log-every", "2",
            "--log-backend", "jsonl", "--checkpoint-dir", str(tmp_path)]
    fl = tmain.main(argv, device="cpu")
    assert isinstance(fl, FleetScheduler) and fl.rounds == 4 and fl.active() == []
    for name in ("a", "b", "w"):
        assert Checkpointer.complete_saves(
            Checkpointer.latest_version_dir(tmp_path / "tenants" / name))
    logged = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert any("tenant/w/loss" in rec for rec in logged)
    again = tmain.main(argv + ["--resume", "true"], device="cpu")
    assert again.rounds == 0 and again.active() == []
