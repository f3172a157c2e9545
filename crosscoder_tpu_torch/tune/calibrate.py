"""Stage 2 of the tuner: measured windows through the Trainer and the
step-identity gate; ported from :mod:`crosscoder_tpu.tune.calibrate`.

Stage 1 ranks on a model; stage 2 believes what it measures. Each
surviving candidate runs a short window through the real
:class:`~crosscoder_tpu_torch.train.trainer.Trainer` (the production step,
source and prefetch worker), scored with the telemetry a run logs anyway:
the ``perf/step_ms`` span EMA and the refill bubble.

Before it is measured a candidate passes :func:`step_identity_gate`. The
JAX package's gate (``contracts_gate``) runs its HLO contract rules over
the lowered step of the candidate and of its projection onto
:data:`~crosscoder_tpu_torch.tune.lattice.STEP_FIELDS`, the assumption
stage 1 priced on: a candidate's data-plane knobs leave the step
unchanged. The port checks it by running it: the first step of the
candidate and that of its projection, each from the seeded initial state
on a seeded batch and recorded by the step rules
(:func:`crosscoder_tpu_torch.analysis.contracts.step_rules.record_step`),
must give bitwise the same loss and state and launch the same kernels the
same number of times, and pass the step rules' identity and dtype rules
(:data:`~crosscoder_tpu_torch.analysis.contracts.step_rules.GATE_RULES`:
the same op stream and launches, no int8 when quant is off, no f64). A
candidate that fails is discarded (``tune/rejected_contract``), never
shipped.
"""

from __future__ import annotations

import dataclasses
import tempfile
import time
from typing import Any

import torch

from crosscoder_tpu_torch.tune import lattice
from crosscoder_tpu_torch.utils.device import resolve_device

# the artifact's gate.rule_set: what the port's gate runs
RULE_SET = ("crosscoder_tpu_torch.tune.calibrate.step_identity_gate+"
            "crosscoder_tpu_torch.analysis.contracts.step_rules.GATE_RULES")
# the span EMA against the synchronized wall clock: past this relative
# difference a window scores on wall_s / steps (ROADMAP C16)
SPAN_WALL_TOL = 0.10


def _field_defaults(cfg_type) -> dict[str, Any]:
    out: dict[str, Any] = {}
    for f in dataclasses.fields(cfg_type):
        if f.default is not dataclasses.MISSING:
            out[f.name] = f.default
        elif f.default_factory is not dataclasses.MISSING:  # type: ignore
            out[f.name] = f.default_factory()  # type: ignore
    return out


def _step_projection_cfg(cfg: Any, knobs: dict[str, Any]):
    """``cfg`` with every tuned knob outside the step fields set back to
    its dataclass default (present but off): the config whose step the
    candidate claimed to share in stage 1. Step knobs and every untuned
    field carry over as they are (``num_tokens`` sets the schedules)."""
    defaults = _field_defaults(type(cfg))
    reset = {k: defaults[k] for k in knobs if k not in lattice.STEP_FIELDS and k in defaults}
    return cfg.replace(**reset)


def kernel_counters() -> dict[str, Any]:
    """Every kernel wrapper's launch counter (``.launches``), by name."""
    from crosscoder_tpu_torch.ops import adam
    from crosscoder_tpu_torch.ops import fused_encoder_topk as fek
    from crosscoder_tpu_torch.ops import paged_attention as pa
    from crosscoder_tpu_torch.ops import quant
    from crosscoder_tpu_torch.ops import sparse_grad as sg
    from crosscoder_tpu_torch.ops import topk_pallas as tp

    return {"paged_attention": pa.paged_attention, "adam_update": adam.adam_update,
            "topk_mask": tp.topk, "topk_mask_f32": tp.topk_mask_f32,
            "topk_chunked": tp.topk_chunked, "sparsify": tp.sparsify,
            "scatter_add_rows": sg.scatter_add_rows, "batchtopk_select": tp.batchtopk_select,
            "batchtopk_emit": tp.batchtopk_emit, "quantize_rows": quant.quantize_rows,
            "fused_topk_encode": fek.fused_topk_encode,
            "fused_topk_encode_q": fek.fused_topk_encode_q,
            "fused_batchtopk_select": fek.fused_batchtopk_select,
            "fused_batchtopk_count": fek.fused_batchtopk_count,
            "fused_batchtopk_emit": fek.fused_batchtopk_emit}


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))


def _state_diffs(a, b) -> list[str]:
    """What differs between two TrainStates, bit for bit: ``[]`` if nothing."""
    out = []
    if (a.step, a.opt_state.count) != (b.step, b.opt_state.count):
        out.append(f"step/count {a.step, a.opt_state.count} vs {b.step, b.opt_state.count}")
    for what, x, y in (("params", a.params, b.params), ("mu", a.opt_state.mu, b.opt_state.mu),
                       ("nu", a.opt_state.nu, b.opt_state.nu),
                       ("aux", a.aux or {}, b.aux or {})):
        if set(x) != set(y):
            out.append(f"{what} keys {sorted(x)} vs {sorted(y)}")
            continue
        out += [f"{what}[{k}]" for k in sorted(x) if not _bits_equal(x[k], y[k])]
    return out


def _one_step(cfg: Any, dev: torch.device):
    """``cfg``'s first step (:func:`step_inputs`), run and recorded by the
    step rules: a :class:`~crosscoder_tpu_torch.analysis.contracts.step_rules.StepRecord`
    (new state, loss, launches, op stream)."""
    from crosscoder_tpu_torch.analysis.contracts.step_rules import record_step

    return record_step(cfg, dev)


def step_inputs(cfg: Any, dev: torch.device):
    """``(step_fn, state, batch, scale)`` of ``cfg``'s first step: its
    seeded initial state, a batch drawn on the device from ``cfg.seed``
    (no source is served) and unit scales, and the step body of the
    variant that step runs."""
    from crosscoder_tpu_torch.train import schedules
    from crosscoder_tpu_torch.train.state import Optimizer, init_train_state
    from crosscoder_tpu_torch.train.trainer import make_step_body, variant_for_step

    opt = Optimizer(cfg, schedules.lr_schedule(cfg))
    state = init_train_state(cfg, opt, device=dev)
    gen = torch.Generator(device=dev).manual_seed(int(cfg.seed))
    batch = torch.randn((cfg.batch_size, cfg.n_sources, cfg.d_in), generator=gen, device=dev)
    scale = torch.ones(cfg.n_sources, device=dev)
    return make_step_body(cfg, opt, *variant_for_step(cfg, state.step)), state, batch, scale


def step_identity_gate(cfg: Any, knobs: dict[str, Any] | None = None,
                       device=None) -> tuple[bool, list]:
    """Check stage 1's assumption for one candidate: with ``knobs`` (its
    tuned assignment), the first step of ``cfg`` and that of
    :func:`_step_projection_cfg` (its data-plane knobs at their defaults),
    each from its config's seeded initial state on a batch drawn on the
    device from the seed (the same state and batch unless a knob reaches
    the step), give bitwise the same loss and state and launch the same
    kernels the same number of times; and the step rules' identity and
    dtype rules (``GATE_RULES``) pass over the two recorded steps, the
    pair labelled as JAX's ``contracts_gate`` labels it. Returns ``(ok,
    findings)``; a harness that raises is a finding (a candidate the gate
    cannot check does not ship). Runs on ``cuda`` unless ``device`` names
    another device."""
    from crosscoder_tpu_torch.analysis.contracts import step_rules
    from crosscoder_tpu_torch.analysis.contracts.engine import run_rules

    dev = resolve_device(device)
    findings: list[str] = []
    try:
        proj = _step_projection_cfg(cfg, knobs or {})
        got = _one_step(cfg, dev)
        want = _one_step(proj, dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        if not _bits_equal(got.loss, want.loss):
            findings.append(f"tune-data-plane: the step's loss {float(got.loss)!r} differs "
                            f"from its projection's {float(want.loss)!r}")
        findings += [f"tune-data-plane: {d} differs from the projection's step"
                     for d in _state_diffs(got.state, want.state)]
        if got.launches != want.launches:
            findings.append(f"tune-data-plane: launches {got.launches} against the "
                            f"projection's {want.launches}")
        ctx = step_rules.gate_context(got, cfg, want, proj)
        report = run_rules(step_rules.rules_named(step_rules.GATE_RULES), ctx)
        findings += [str(f)[:500] for f in report.findings if f.severity == "error"]
    except Exception as e:  # noqa: BLE001 — a crashed harness is a finding, not a pass
        findings.append(f"tune-gate-harness: {type(e).__name__}: {e}"[:500])
    return not findings, findings


def measure_window(cfg: Any, *, steps: int = 6, warmup: int = 2, n_devices: int = 1,
                   device=None) -> dict[str, float]:
    """One short calibration window through the real Trainer.

    The window runs with ``obs="on"`` whatever the candidate's own setting
    (the telemetry is the measurement; its cost is the same for every
    candidate) into a throwaway checkpoint directory, logging nothing. The
    card is synchronized at both ends of the window. Scoring, the JAX
    package's: the ``perf/step_ms`` span EMA inflated by the measured
    refill bubble, ``effective_ms = step_ms / (1 - bubble)`` (bubble capped
    at 0.95), so a candidate whose data plane starves the loop loses even
    when its step is fast. The port's step span closes when the step's
    launches are queued, not when the card has run them: where the span
    EMA and the synchronized ``wall_s / steps`` differ by more than
    :data:`SPAN_WALL_TOL`, the window scores on ``wall_s / steps``
    (``scored_on``: ``"span"`` or ``"wall"``; ROADMAP C16). The score is
    acts/s/chip at the effective rate. Runs on ``cuda`` unless ``device``
    names another device."""
    from crosscoder_tpu_torch.train.trainer import Trainer

    dev = resolve_device(device)

    def sync(m) -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        else:
            float(m["loss"])

    with tempfile.TemporaryDirectory(prefix="tune_cal_") as tmp:
        run_cfg = cfg.replace(obs="on", obs_dir="", checkpoint_dir=tmp, log_backend="null",
                              save_every=10**9, num_tokens=10**12)
        tr = Trainer(run_cfg, device=dev)
        try:
            m = None
            for _ in range(max(1, warmup)):
                m = tr.step(full_metrics=False)
            sync(m)
            tr._obs.take_blocked_s()            # the bubble clock starts here
            t0 = time.perf_counter()
            for _ in range(max(1, steps)):
                m = tr.step(full_metrics=False)
            sync(m)
            wall_s = max(1e-9, time.perf_counter() - t0)
            blocked_s = tr._obs.take_blocked_s()
            snap = tr._obs.registry.snapshot()
        finally:
            tr.close()
    wall_ms = 1e3 * wall_s / max(1, steps)
    step_ms = float(snap.get("perf/step_ms", wall_ms))
    bubble = min(0.95, max(0.0, blocked_s / wall_s))
    scored_on = "span" if abs(step_ms - wall_ms) <= SPAN_WALL_TOL * wall_ms else "wall"
    effective_ms = step_ms / (1.0 - bubble) if scored_on == "span" else wall_ms
    score = cfg.batch_size * 1e3 / (effective_ms * max(1, n_devices))
    return {
        "step_ms": step_ms,
        "bubble_frac": bubble,
        "effective_step_ms": effective_ms,
        "acts_per_sec_chip": score,
        "wall_s": wall_s,
        "steps": float(steps),
        "score": score,
        "wall_step_ms": wall_ms,
        "scored_on": scored_on,
    }
