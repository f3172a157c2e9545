"""Static correctness plane CLI, the port's ``scripts/analyze.py``:

    python -m crosscoder_tpu_torch.analysis.contracts [--device cpu] [--json]

Runs the rule packs of :mod:`crosscoder_tpu_torch.analysis.contracts` over
the shipped tree and exits nonzero on any error-severity finding (or, on
the card, a tail probe that misses its bar or differs between two runs,
which stands even where the sanitizer rules are skipped):

- step rules: the recorded train step across JAX's knob lattice (op
  streams plus launches identical when a knob is off, dtype bans,
  donation, host transfers, host-made tensors; the fused-live train and
  serve steps carry no ``[B, dict]`` tensor, on the card only);
- kernel safety: every library's probes on the card (launch limits,
  shared memory and registers, tails under ``memcheck`` and against the
  plain versions, ``racecheck`` and repeat runs, spills as warnings);
- repo-wide AST lints and the compile tier's key completeness.

It runs on ``cuda`` unless ``--device cpu`` is given, and raises without a
card. On the CPU the kernel pack and the fused-live rules land in
``skipped``, their reasons in ``info`` (``skipped/<rule>``). ``--json``
prints exactly one JSON document on stdout; progress rides stderr.
``--mutate RULE`` runs RULE over its seeded violation (``mutations.py``):
the expected outcome is findings and a nonzero exit. Suppression:
``--allow RULE`` (recorded as suppressed) or a ``# contracts:
allow(RULE)`` comment on a flagged source line (AST lints).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import sys


def _parse_args(argv: list[str] | None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m crosscoder_tpu_torch.analysis.contracts",
                                description="the port's static correctness plane")
    p.add_argument("--json", action="store_true",
                   help="emit one JSON document on stdout")
    p.add_argument("--allow", action="append", default=[],
                   help="suppress a rule by name (repeatable, or comma-separated); "
                        "recorded as suppressed")
    p.add_argument("--skip-steps", action="store_true",
                   help="skip the recorded step lattice")
    p.add_argument("--skip-kernels", action="store_true",
                   help="skip the kernel probes")
    p.add_argument("--skip-lints", action="store_true",
                   help="skip the repo-wide AST lints and the cache-key rule")
    p.add_argument("--mutate", metavar="RULE",
                   help="run RULE over its seeded-violation fixture (self-test; "
                        "nonzero exit = rule fired = pass)")
    p.add_argument("--list", action="store_true", dest="list_rules",
                   help="list every rule with its description and exit")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs the plain paths)")
    return p.parse_args(argv)


def _allow_set(args: argparse.Namespace) -> frozenset[str]:
    names: set[str] = set()
    for item in args.allow:
        names.update(s.strip() for s in item.split(",") if s.strip())
    return frozenset(names)


def _note_skips(report, reasons: dict[str, str]) -> None:
    for rule, why in reasons.items():
        if rule in report.skipped:
            report.info[f"skipped/{rule}"] = why


def build_report(args: argparse.Namespace):
    from crosscoder_tpu_torch.analysis.contracts import (AST_RULES, CACHE_RULES, KERNEL_RULES,
                                                         STEP_RULES, Report, kernel_safety,
                                                         build_cache_key_context,
                                                         build_source_context,
                                                         build_step_context, run_kernel_probes,
                                                         run_rules, smem_summary)
    from crosscoder_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    allow = _allow_set(args)
    report = Report()
    tails_failed = False
    if not args.skip_lints:
        print("analyze: AST lints ...", file=sys.stderr)
        report.merge(run_rules(AST_RULES, build_source_context(), allow))
        print("analyze: compile-cache key completeness ...", file=sys.stderr)
        report.merge(run_rules(CACHE_RULES, build_cache_key_context(), allow))
    if not args.skip_kernels:
        print(f"analyze: kernel probes on {dev} ...", file=sys.stderr)
        kctx = run_kernel_probes(dev)
        kernels = run_rules(KERNEL_RULES, kctx, allow)
        if kctx.launches:
            kernels.info.update(smem_summary(kctx))
            kernels.info["kernel/tails"] = kernel_safety.tail_summary(kctx)
        _note_skips(kernels, kctx.skip_reasons)
        report.merge(kernels)
        tails_failed = bool(kernel_safety.tail_failures(kctx))
    if not args.skip_steps:
        print(f"analyze: step lattice on {dev} ...", file=sys.stderr)
        sctx = build_step_context(dev, full=True)
        steps = run_rules(STEP_RULES, sctx, allow)
        _note_skips(steps, sctx.skip_reasons)
        report.merge(steps)
    return report, tails_failed


def main(argv: list[str] | None = None) -> int:
    args = _parse_args(argv)

    if args.list_rules:
        from crosscoder_tpu_torch.analysis.contracts import ALL_RULES
        for rule in ALL_RULES:
            print(  # contracts: allow(lint-no-stdout-print) — the CLI's output
                f"{rule.name:36s} {rule.description}")
        return 0

    if args.mutate:
        from crosscoder_tpu_torch.analysis.contracts import MUTATIONS, run_mutation
        if args.mutate not in MUTATIONS:
            print(f"analyze: unknown rule {args.mutate!r}; choose from: "
                  f"{', '.join(sorted(MUTATIONS))}", file=sys.stderr)
            return 2
        report = run_mutation(args.mutate)
        print(  # contracts: allow(lint-no-stdout-print) — the CLI's output
            report.to_json() if args.json else report.format_human())
        return 1 if report.findings else 0

    # anything that is not the report must not land on the --json stream
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        report, tails_failed = build_report(args)
    leaked = buf.getvalue()
    if leaked:
        sys.stderr.write(leaked)
    print(  # contracts: allow(lint-no-stdout-print) — the CLI's output
        report.to_json() if args.json else report.format_human())
    return 0 if report.ok and not tails_failed else 1


if __name__ == "__main__":
    sys.exit(main())
