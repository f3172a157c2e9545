"""The port's step rules (crosscoder_tpu_torch/analysis/contracts/
step_rules.py) against the JAX package's HLO rules on the CPU:

- the lattice: the port records JAX's variants under JAX's labels, and for
  every identity pair of JAX's lattice JAX's verdict (the lowered texts
  equal) is the port's (the op streams and launches equal);
- every applicable rule is clean on the CPU, and the fused-live rules are
  skipped there (their plain versions build ``[B, dict]``, which the
  serve encode's recording on the CPU shows);
- the donation rule over the AuxK tracker (C20): a donated step keeps every
  leaf's storage and is bitwise the undonated step;
- K9's f32 select makes its state on the card (C21): no host copy;
- the recorder: what counts as a host transfer, a host-made tensor, an
  int8 or f64 tensor; the tuner's gate runs the identity and dtype rules.
"""

import numpy as np
import pytest
import torch

from crosscoder_tpu.analysis.contracts import hlo_rules as jhlo
from crosscoder_tpu.analysis.contracts.engine import run_rules as jrun_rules
from crosscoder_tpu_torch.analysis.contracts import STEP_RULES, run_rules, step_rules
from crosscoder_tpu_torch.analysis.contracts.step_rules import (OpRecord, StepContext,
                                                                TensorMeta, VariantMeta)
from crosscoder_tpu_torch.ops import topk_pallas as tp
from crosscoder_tpu_torch.tune import calibrate, lattice

# JAX's identity pairs, by label (hlo_rules.build_step_context)
JAX_PAIRS = ([("base", f"off:{label}", label) for label, _ in jhlo.KNOB_OFF_LATTICE]
             + [("base", "off:tuned", "tuned")]
             + [(f"{a}:fused_off", f"{a}:fused_auto_dead", f"fused_encoder[{a}]")
                for a in ("topk", "batchtopk")]
             + [("topk:sparse_off", "topk:sparse_auto_dead", "sparse_bwd")])


@pytest.fixture(scope="module")
def jax_ctx():
    return jhlo.build_step_context(full=False)


@pytest.fixture(scope="module")
def port_ctx():
    return step_rules.build_step_context("cpu", full=True)


def test_the_port_records_jaxs_lattice(jax_ctx, port_ctx):
    assert port_ctx.identity_pairs == jax_ctx.identity_pairs == JAX_PAIRS
    assert set(port_ctx.ops) == set(jax_ctx.texts)
    assert [label for label, _ in step_rules.knob_off_lattice("/tmp")] == \
        [label for label, _ in jhlo.KNOB_OFF_LATTICE]
    assert step_rules.knob_off_lattice("/tmp") == jhlo.KNOB_OFF_LATTICE
    assert (step_rules._SPARSE_SHAPE, step_rules._FUSED_SHAPE) == (jhlo._SPARSE_SHAPE,
                                                                   jhlo._FUSED_SHAPE)


@pytest.mark.parametrize("pair", JAX_PAIRS, ids=lambda p: p[2])
def test_each_identity_verdict_is_jaxs(jax_ctx, port_ctx, pair):
    a, b, _ = pair
    want = jax_ctx.texts[a] == jax_ctx.texts[b]
    assert step_rules.same_program(port_ctx, a, b) == want
    assert want                                    # JAX's lattice holds


def test_every_applicable_rule_is_clean_on_the_cpu(port_ctx):
    rep = run_rules(STEP_RULES, port_ctx)
    assert rep.ok and not rep.findings, "\n".join(str(f) for f in rep.findings)
    assert set(rep.skipped) == set(step_rules.FUSED_RULES)
    assert set(rep.checked) == {r.name for r in STEP_RULES} - set(step_rules.FUSED_RULES)
    assert port_ctx.skip_reasons == dict.fromkeys(step_rules.FUSED_RULES,
                                                  step_rules.CPU_FUSED_REASON)


def test_jaxs_rules_are_clean_on_jaxs_lattice(jax_ctx):
    assert jrun_rules(jhlo.HLO_RULES, jax_ctx).ok


def test_the_plain_serve_encode_builds_the_dense_preacts():
    """Why the fused-live rules are skipped on the CPU: the plain version
    of the fused encoder builds the ``[B, dict]`` matrix the rule forbids."""
    cfg = step_rules._cfg(activation="topk", fused_encoder="on", sparse_bwd="on", serve="on",
                          **step_rules._FUSED_SHAPE)
    rec = step_rules.record_serve_step(cfg, "cpu")
    ctx = StepContext()
    ctx.add("serve:encode_fused", rec, VariantMeta(serve_step=True,
                                                   forbid_dense_shape=(192, 1024)))
    rep = run_rules(STEP_RULES, ctx)
    assert [f.rule for f in rep.findings] == ["step-serve-no-dense-preacts"]
    vals, idx, diff = rec.outputs
    assert vals.shape == idx.shape == diff.shape == (192, 8)


@pytest.mark.parametrize("kw", [
    dict(activation="relu"),
    dict(activation="topk", topk_k=4, l1_coeff=0.0, sparse_bwd="on", aux_k=8),
    dict(activation="topk", topk_k=4, l1_coeff=0.0, aux_k=8, aux_mask_every=4),
    dict(activation="batchtopk", topk_k=4, l1_coeff=0.0),
    dict(activation="jumprelu", l0_coeff=1.0),
    dict(activation="topk", topk_k=4, l1_coeff=0.0, resample_every=3),
    dict(enc_dtype="bf16", master_dtype="bf16"),
], ids=["relu", "topk-aux", "topk-aux-cached-mask", "batchtopk", "jumprelu", "resample",
        "bf16-masters"])
def test_the_step_rules_hold_across_activations(kw):
    cfg = step_rules._cfg(d_in=16, dict_size=256, **kw)
    rec = step_rules.record_step(cfg, "cpu")
    ctx = StepContext()
    ctx.add("v", rec, step_rules.train_meta(cfg, rec))
    rep = run_rules(STEP_RULES, ctx)
    assert rep.ok and not rep.findings, "\n".join(str(f) for f in rep.findings)
    assert not rec.moved and rec.n_leaves >= 12


# ---------------------------------------------------------------------------
# C20: the donated step writes the AuxK tracker in place


@pytest.mark.parametrize("kw", [dict(aux_k=8), dict(aux_k=8, aux_mask_every=4),
                                dict(aux_k=0, resample_every=3)],
                         ids=["aux", "aux-cached-mask", "resample"])
def test_a_donated_step_keeps_every_leaf_and_is_bitwise_the_undonated(kw):
    cfg = step_rules._cfg(activation="topk", topk_k=4, l1_coeff=0.0, sparse_bwd="on",
                          d_in=16, dict_size=256, aux_every=2, **kw)
    dev = torch.device("cpu")
    fn, state, batch, scale = calibrate.step_inputs(cfg, dev)
    fn2, state2, _, _ = calibrate.step_inputs(cfg, dev)
    leaves = step_rules._leaves(state2)
    ptrs = {k: step_rules._storage(v) for k, v in leaves.items()}
    for _ in range(3):                      # across an AuxK and a plain variant
        state, m = fn(state, batch, scale)
        state2, m2 = fn2(state2, batch, scale, donate=True)
        assert calibrate._state_diffs(state, state2) == []
        assert float(m["loss"]) == float(m2["loss"])
    new = step_rules._leaves(state2)
    assert set(new) == set(leaves) and all(step_rules._storage(new[k]) == ptrs[k]
                                           for k in leaves)


def test_the_donation_rule_sees_a_replaced_aux_leaf():
    cfg = step_rules._cfg(activation="topk", topk_k=4, l1_coeff=0.0, d_in=16, dict_size=256,
                          aux_k=8)
    rec = step_rules.record_step(cfg, "cpu")
    assert rec.moved == [] and "aux/steps_since_fired" in step_rules._leaves(rec.state)
    rec.moved = ["aux/steps_since_fired"]          # the step before the repair
    ctx = StepContext()
    ctx.add("aux", rec, step_rules.train_meta(cfg, rec))
    rep = run_rules([r for r in STEP_RULES if r.name == "step-donation-honored"], ctx)
    assert [f.location for f in rep.findings] == ["aux"]


# ---------------------------------------------------------------------------
# C21: K9's f32 select makes its bisection state on the card


def test_k9_f32_select_copies_nothing_from_the_host(monkeypatch):
    h = torch.randn(4, 64)
    seen = []

    class FakeLib:
        def batchtopk_select_f32(self, flat, n, kk, vec, state, kth, passes, stream):
            seen.append(state)
            return 0

    from crosscoder_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "load", lambda name, protos=None: FakeLib())
    monkeypatch.setattr(_build, "stream", lambda dev: 0)
    monkeypatch.setattr(tp, "_check_bt", lambda h, name: h.reshape(-1).contiguous())
    rec = step_rules._recorder()
    before = tp.batchtopk_select.launches
    dev_h = h.to("meta")                           # the kernel path: not a CPU tensor
    with rec:
        tp.batchtopk_select(dev_h, 8)
    tp.batchtopk_select.launches = before
    assert seen
    names = [op.name for op in rec.ops]
    assert "aten::zeros.default" in names and "aten::fill_.Scalar" in names
    assert not any(step_rules._is_transfer(op) for op in rec.ops)
    assert not rec.host_consts


# ---------------------------------------------------------------------------
# the recorder and the rules' predicates


def _op(name, ins=(), outs=()):
    return OpRecord(name, tuple(ins), tuple(outs))


@pytest.mark.parametrize("op,transfer", [
    (_op("aten::_local_scalar_dense.default", [TensorMeta((), "float32", "cuda", 4)]), True),
    (_op("aten::_local_scalar_dense.default", [TensorMeta((), "float32", "cpu", 4)]), False),
    (_op("aten::nonzero.default", [TensorMeta((8,), "bool", "cuda", 8)],
         [TensorMeta((2, 1), "int64", "cuda", 16)]), True),
    (_op("aten::_to_copy.default", [TensorMeta((4,), "int64", "cpu", 32)],
         [TensorMeta((4,), "int64", "cuda", 32)]), True),
    (_op("aten::_to_copy.default", [TensorMeta((4,), "float32", "cuda", 16)],
         [TensorMeta((4,), "float32", "cpu", 16)]), True),
    (_op("aten::_to_copy.default", [TensorMeta((4,), "float32", "cuda", 16)],
         [TensorMeta((4,), "bfloat16", "cuda", 8)]), False),
    (_op("aten::mm.default", [TensorMeta((4, 4), "float32", "cuda", 64)],
         [TensorMeta((4, 4), "float32", "cuda", 64)]), False),
])
def test_what_counts_as_a_host_transfer(op, transfer):
    assert step_rules._is_transfer(op) == transfer


def test_the_recorder_sees_host_data_syncs_and_dtypes():
    rec = step_rules._recorder()
    x = torch.ones(4, requires_grad=True)
    with rec:
        big = torch.tensor(np.zeros(1 << 17, np.float32).tolist())    # 512 KiB from host data
        with torch.autograd.profiler.record_function("span"):
            y = (x.double() * 2).sum()
        (g,) = torch.autograd.grad(y, [x])
        float(y)
    names = [op.name for op in rec.ops]
    assert not any(n.startswith("profiler::") for n in names)
    assert "aten::_local_scalar_dense.default" in names         # the backward is recorded too
    assert any(op.name.startswith("aten::mul") and op.outputs[0].dtype == "float64"
               for op in rec.ops)
    assert rec.host_consts[0][0] == big.numel() * 4
    ctx = StepContext()
    ctx.add("v", step_rules.StepRecord(ops=rec.ops, host_consts=rec.host_consts),
            VariantMeta())
    fired = {f.rule for f in run_rules(STEP_RULES, ctx).findings}
    assert fired == {"step-no-f64", "step-no-large-host-consts"}      # the CPU sync is no transfer


def test_the_gate_runs_the_step_rules_on_a_smuggled_knob(monkeypatch):
    monkeypatch.setattr(lattice, "STEP_FIELDS", lattice.STEP_FIELDS - {"topk_k"})
    cfg = step_rules._cfg(activation="topk", topk_k=4, l1_coeff=0.0, d_in=16, dict_size=256)
    ok, findings = calibrate.step_identity_gate(cfg, knobs={"topk_k": 4}, device="cpu")
    assert not ok
    assert any(f.startswith("step-knob-off-identity [tune:step_projection vs tune:candidate]")
               for f in findings), findings
    assert "step_rules.GATE_RULES" in calibrate.RULE_SET


def test_the_gate_context_is_jaxs_contracts_gate_pair():
    cfg = step_rules._cfg()
    rec = step_rules.record_step(cfg, "cpu")
    ctx = step_rules.gate_context(rec, cfg, rec, cfg)
    assert ctx.identity_pairs == [("tune:step_projection", "tune:candidate", "tune-data-plane")]
    rep = run_rules(step_rules.rules_named(step_rules.GATE_RULES), ctx)
    assert rep.ok and sorted(rep.checked) == sorted(step_rules.GATE_RULES)
