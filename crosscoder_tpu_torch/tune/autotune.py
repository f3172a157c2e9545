"""The search: lattice → static rank → calibrate the top K → pin the
winner; ported from :mod:`crosscoder_tpu.tune.autotune`.

One call, :func:`tune`, runs the two-stage search and emits the pinned
``TUNED.json``. The default-knob candidate (the base config's own value on
every axis) is ALWAYS calibrated beside the stage-1 top K: the winner is
chosen on measured score, so an artifact never ships knobs that measure
worse than the ones the user had.

The search's accounting lands in the JAX package's ``tune/*`` keys:
candidates enumerated, pruned, priced and calibrated, gate rejections
(``tune/rejected_contract``) and the artifacts emitted. Pass a registry to
fold them into a run's metrics, or let :func:`tune` keep its own.
"""

from __future__ import annotations

import functools
import json
import sys
from typing import Any

from crosscoder_tpu_torch.obs.registry import MetricsRegistry
from crosscoder_tpu_torch.parallel import multihost
from crosscoder_tpu_torch.tune.artifact import TunedArtifact, config_hash, topology_key
from crosscoder_tpu_torch.tune.calibrate import RULE_SET, measure_window, step_identity_gate
from crosscoder_tpu_torch.tune.lattice import (Candidate, default_axes, enumerate_lattice,
                                               price_candidate, rank_candidates)
from crosscoder_tpu_torch.utils import compile_cache
from crosscoder_tpu_torch.utils.device import resolve_device


def _note(msg: str) -> None:
    print(f"[crosscoder_tpu_torch] tune: {msg}", file=sys.stderr, flush=True)


def tune(base_cfg: Any, objective: str = "train", *, axes: dict[str, tuple] | None = None,
         top_k: int = 2, out_path: str | None = None, n_devices: int | None = None,
         seed: int = 0, steps: int = 6, warmup: int = 2,
         registry: MetricsRegistry | None = None, measure: Any = None, gate: Any = None,
         device=None) -> TunedArtifact:
    """Run the two-stage search and return the pinned artifact.

    ``measure(cfg, steps=, warmup=, n_devices=)`` and ``gate(cfg, knobs=)``
    can be injected (races and violations are rigged through them); the
    defaults are :func:`~crosscoder_tpu_torch.tune.calibrate.measure_window`
    and :func:`~crosscoder_tpu_torch.tune.calibrate.step_identity_gate` on
    ``device``, which is ``cuda`` unless the caller names another (no card
    and no device named raises, whatever is injected). ``n_devices``
    defaults to the process group's world size. ``out_path``, when set,
    receives the artifact through the atomic writer. Raises
    :class:`ValueError` when the lattice is empty or the gate rejected
    every calibrated candidate.
    """
    dev = resolve_device(device)
    reg = registry if registry is not None else MetricsRegistry()
    # the persistent compile tier: a re-run's calibration windows load the
    # kernel libraries instead of compiling them
    compile_cache.configure(base_cfg, registry=reg)
    measure = measure if measure is not None else functools.partial(measure_window, device=dev)
    gate = gate if gate is not None else functools.partial(step_identity_gate, device=dev)
    if n_devices is None:
        n_devices = multihost.world_size()
    axes = axes if axes is not None else default_axes(base_cfg, objective)

    # -- stage 1: enumerate and rank --------------------------------------
    cands, pruned = enumerate_lattice(base_cfg, axes)
    reg.count("tune/candidates", len(cands))
    if pruned:
        reg.count("tune/pruned_invalid", pruned)
    if not cands:
        raise ValueError(f"tune: every lattice point over axes {sorted(axes)} failed config "
                         f"validation — nothing to search")
    ranked = rank_candidates(cands, objective, n_devices, seed)
    if not ranked:
        raise ValueError("tune: stage-1 pricing failed for every candidate — nothing to "
                         "calibrate")
    reg.count("tune/priced", len(ranked))
    _note(f"{objective}: {len(ranked)} candidates priced ({pruned} pruned invalid), "
          f"calibrating top {top_k}")

    # -- the calibration set: the stage-1 top K and the default knobs ------
    to_calibrate = list(ranked[:max(1, top_k)])
    default_knobs = {k: getattr(base_cfg, k) for k in axes}
    if not any(c.knobs == default_knobs for c in to_calibrate):
        existing = next((c for c in ranked if c.knobs == default_knobs), None)
        if existing is not None:
            to_calibrate.append(existing)
        else:
            try:
                dflt = Candidate(knobs=default_knobs, cfg=base_cfg, base_sig=ranked[0].base_sig)
                price_candidate(dflt, objective, n_devices)
                to_calibrate.append(dflt)
            except Exception as e:  # noqa: BLE001 — the baseline is best effort
                _note(f"default-knob baseline unpriceable ({type(e).__name__}: {e}); "
                      f"calibrating top-K only")

    # -- stage 2: the gate and the measured windows ------------------------
    audit: list[dict[str, Any]] = []
    survivors: list[tuple[Candidate, dict[str, float]]] = []
    n_rejected = 0
    for cand in to_calibrate:
        row = {"knobs": cand.knobs, "predicted_score": cand.predicted.get("score")}
        ok, findings = gate(cand.cfg, knobs=cand.knobs)
        if not ok:
            n_rejected += 1
            reg.count("tune/rejected_contract")
            row["gate"] = "rejected"
            row["findings"] = [str(f) for f in findings][:8]
            _note(f"REJECTED by the step-identity gate: {cand.label} ({len(findings)} "
                  f"finding(s): {findings[0] if findings else ''})")
            audit.append(row)
            continue
        row["gate"] = "pass"
        measured = measure(cand.cfg, steps=steps, warmup=warmup, n_devices=n_devices)
        reg.count("tune/calibrated")
        row["measured_score"] = measured.get("score")
        survivors.append((cand, measured))
        audit.append(row)
    if not survivors:
        raise ValueError(f"tune: all {len(to_calibrate)} calibrated candidates were rejected "
                         f"by the step-identity gate — refusing to emit an artifact")

    # the winner on MEASURED score; exact ties fall back to the stage-1
    # prediction, then the canonical knob JSON
    def key(item):
        cand, measured = item
        return (-float(measured.get("score", float("-inf"))),
                -float(cand.score if cand.score is not None else float("-inf")),
                json.dumps(cand.knobs, sort_keys=True, default=str))

    survivors.sort(key=key)
    winner, measured = survivors[0]
    winner_cfg = base_cfg.replace(**winner.knobs)
    n_model = max(1, int(winner_cfg.model_axis_size))
    art = TunedArtifact(
        objective=objective,
        knobs=dict(winner.knobs),
        mesh={"n_devices": int(n_devices), "n_model": n_model,
              "n_data": max(1, int(n_devices) // n_model)},
        predicted=dict(winner.predicted),
        measured=dict(measured),
        gate={"rule_set": RULE_SET, "checked": len(to_calibrate), "rejected": n_rejected},
        search={"axes": {k: list(v) for k, v in sorted(axes.items())},
                "n_candidates": len(cands), "n_pruned_invalid": pruned,
                "n_priced": len(ranked), "top_k": int(top_k), "seed": int(seed),
                "calibration_steps": int(steps), "topology": topology_key(n_devices, n_model),
                "candidates": audit},
        config_hash=config_hash(winner_cfg),
    )
    reg.count("tune/emitted")
    if out_path:
        art.save(out_path)
        _note(f"winner {winner.label} (measured score {measured.get('score'):.4g}) pinned to "
              f"{out_path}")
    return art
