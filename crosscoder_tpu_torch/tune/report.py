"""Render a pinned ``TUNED.json`` as a readable table; the port's
counterpart of the JAX package's ``scripts/tune_report.py``, with the same
output:

    python -m crosscoder_tpu_torch.tune.report <TUNED.json> [--json]

prints the chosen knobs, the stage-1 predicted against the stage-2
measured scores, the gate's audit (candidates checked and rejected, each
calibrated candidate's gate status) and the search's provenance (axes,
lattice size, seed, topology, config hash). ``--json`` re-emits the
validated artifact instead. Exits 2 on a malformed artifact (unreadable,
not JSON, keys missing or of the wrong type).
"""

from __future__ import annotations

import argparse
import json
import sys


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


def render(art) -> str:
    """The report text of one validated artifact."""
    lines: list[str] = []
    m = art.mesh
    lines.append(f"objective: {art.objective}    topology: {art.topology} "
                 f"(n_devices={m.get('n_devices')}, n_model={m.get('n_model')})")
    lines.append(f"config_hash: {art.config_hash or '(unset)'}")

    hdr = f"{'knob':<24} {'chosen':>14}"
    lines += ["", hdr, "-" * len(hdr)]
    for k in sorted(art.knobs):
        lines.append(f"{k:<24} {_fmt(art.knobs[k]):>14}")

    hdr = f"{'metric':<24} {'predicted':>14} {'measured':>14}"
    lines += ["", hdr, "-" * len(hdr)]
    for k in sorted(set(art.predicted) | set(art.measured)):
        p = art.predicted.get(k)
        mv = art.measured.get(k)
        lines.append(f"{k:<24} {_fmt(p) if p is not None else '-':>14} "
                     f"{_fmt(mv) if mv is not None else '-':>14}")

    g = art.gate
    lines += ["", f"contracts gate: {g.get('checked', '?')} candidate(s) checked, "
                  f"{g.get('rejected', '?')} rejected "
                  f"({g.get('rule_set', 'unknown rule set')})"]
    cands = art.search.get("candidates") or []
    if cands:
        hdr = f"{'candidate knobs':<52} {'gate':>8} {'predicted':>12} {'measured':>12}"
        lines += ["", hdr, "-" * len(hdr)]
        for row in cands:
            knobs = ",".join(f"{k}={v}" for k, v in sorted(row.get("knobs", {}).items()))
            pred = row.get("predicted_score")
            meas = row.get("measured_score")
            lines.append(f"{knobs[:52]:<52} {row.get('gate', '?'):>8} "
                         f"{_fmt(pred) if pred is not None else '-':>12} "
                         f"{_fmt(meas) if meas is not None else '-':>12}")

    s = art.search
    lines += ["", f"search: {s.get('n_candidates', '?')} candidates over axes "
                  f"{sorted(s.get('axes', {}))} ({s.get('n_pruned_invalid', 0)} pruned invalid, "
                  f"{s.get('n_priced', '?')} priced, top_k={s.get('top_k', '?')}, "
                  f"seed={s.get('seed', '?')}, {s.get('calibration_steps', '?')} calibration "
                  f"steps)"]
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    from crosscoder_tpu_torch.tune.artifact import load_tuned

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("artifact", help="path to TUNED.json")
    ap.add_argument("--json", action="store_true",
                    help="re-emit the validated artifact as JSON instead of the table")
    args = ap.parse_args(argv)
    try:
        art = load_tuned(args.artifact)
    except ValueError as e:
        print(f"tune_report: MALFORMED ARTIFACT: {e}", file=sys.stderr)
        return 2
    if args.json:
        print(  # contracts: allow(lint-no-stdout-print) — the CLI's output
            json.dumps(art.to_dict(), indent=2, sort_keys=True, default=str))
        return 0
    print(render(art))  # contracts: allow(lint-no-stdout-print) — the CLI's output
    return 0


if __name__ == "__main__":
    sys.exit(main())
