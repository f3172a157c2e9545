"""CE-recovered acceptance gate, ported from ``scripts/eval_ce.py``: the
reference's only published-value quality metric (nb:cell 30: CE recovered
0.9219 base / 0.9258 IT on the published checkpoint) as a command.

Modes::

    # a locally trained checkpoint, both models as local HF directories
    python -m crosscoder_tpu_torch.eval_ce --version-dir checkpoints/version_0 \\
        --model-a ./gemma-2-2b --model-b ./gemma-2-2b-it --tokens tokens.npy \\
        --norm-factors 0.2759,0.2442

    # air-gapped: trains the demo pair and a crosscoder, folds it and runs
    # the splicing eval with the identity and zero oracles
    python -m crosscoder_tpu_torch.eval_ce --demo --device cpu --out ce_gate.json

Runs on ``cuda`` unless ``--device`` (or ``main(device=...)``) names
another device. ``--hf`` (the published checkpoint and Gemma-2-2B pair)
needs downloads and is not ported. The demo is not the published-value
comparison: it checks that the trained crosscoder's recovered CE lands far
above the zero-reconstruction floor and at or below the identity ceiling,
and, at the default step counts on the CPU, within a band of the values
this module recorded there.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from crosscoder_tpu_torch import demo
from crosscoder_tpu_torch.analysis.ce_eval import (
    crosscoder_reconstruct_fn, get_ce_recovered_metrics,
)
from crosscoder_tpu_torch.checkpoint import Checkpointer
from crosscoder_tpu_torch.models import crosscoder as cc
from crosscoder_tpu_torch.models import lm
from crosscoder_tpu_torch.replicate import HF_NOT_PORTED, load_tokens, positive_int
from crosscoder_tpu_torch.utils.device import resolve_device

# published norm scaling factors and CE recovered of the published
# checkpoint (nb:cells 27, 30; BASELINE.md)
PUBLISHED_FACTORS = (0.2758961493232058, 0.24422852496546169)
PUBLISHED_RECOVERED = {"A": 0.921875, "B": 0.92578125}

# the demo's recovered CE at the default step counts, recorded from this
# module's run on the CPU (the port's demo weights come from PyTorch's
# generator, so the JAX package's recorded values do not apply); the band
# is checked only at those steps on that device type
DEMO_EXPECTED_RECOVERED = {"A": 1.0135, "B": 0.9790}
DEMO_BAND = 0.05
DEMO_DEFAULT_STEPS = (400, 1500)  # (--demo-lm-steps, --demo-cc-steps)
DEMO_EXPECTED_DEVICE = "cpu"


def run_real(args, device=None) -> dict:
    """The gate against a local checkpoint and two local HF directories."""
    if args.hf:
        raise NotImplementedError(HF_NOT_PORTED)
    if not args.norm_factors:
        raise SystemExit(
            "--norm-factors a,b is required with --version-dir (the factors the buffer "
            "calibrated during training; they are in the save's meta)")
    dev = resolve_device(device)
    params, cfg = Checkpointer.load_weights(args.version_dir, args.save, device=dev)
    factors = [float(x) for x in args.norm_factors.split(",")]
    folded = cc.fold_scaling_factors(params, factors)
    pa, lm_cfg = lm.from_hf(args.model_a, device=dev)
    pb, _ = lm.from_hf(args.model_b, lm_cfg, device=dev)
    tokens = load_tokens(args.tokens)
    tokens = tokens[: args.n_seqs] if args.n_seqs else tokens
    return get_ce_recovered_metrics(tokens, lm_cfg, [pa, pb], cfg.hook_point,
                                    crosscoder_reconstruct_fn(folded, cfg), chunk=args.chunk)


def run_demo(args, device=None) -> dict:
    """The whole gate, air-gapped: synthetic language → two trained tiny
    LMs → harvest → crosscoder training → fold → splice eval, with the
    identity and zero oracles."""
    dev = resolve_device(device)
    print("[demo] training tiny LM pair on the synthetic language ...", file=sys.stderr,
          flush=True)
    lm_cfg, model_params, tokens, lm_ces = demo.build_demo_pair(args.demo_lm_steps, device=dev)
    print(f"[demo] LM train CE: A={lm_ces['A']:.3f} B={lm_ces['B']:.3f} "
          f"(uniform={lm_ces['uniform']:.3f})", file=sys.stderr, flush=True)
    print(f"[demo] training crosscoder for {args.demo_cc_steps} steps ...", file=sys.stderr,
          flush=True)
    params, cfg, norm_factors, final = demo.train_demo_crosscoder(
        lm_cfg, model_params, tokens, args.demo_cc_steps, device=dev)
    folded = cc.fold_scaling_factors(params, norm_factors)
    eval_tokens = tokens[: args.n_seqs or 64]
    hook = demo.DEMO_HOOK

    print("[demo] oracle checks ...", file=sys.stderr, flush=True)
    ident = get_ce_recovered_metrics(eval_tokens, lm_cfg, model_params, hook, lambda x: x,
                                     chunk=args.chunk)
    zero = get_ce_recovered_metrics(eval_tokens, lm_cfg, model_params, hook, torch.zeros_like,
                                    chunk=args.chunk)
    metrics = get_ce_recovered_metrics(eval_tokens, lm_cfg, model_params, hook,
                                       crosscoder_reconstruct_fn(folded, cfg), chunk=args.chunk)
    out = {
        "mode": "demo (air-gapped; synthetic-language LM pair, trained crosscoder)",
        "lm_train_ce": lm_ces,
        "crosscoder_final": {k: float(v) for k, v in final.items()},
        **metrics,
        "oracle_identity_recovered": {"A": ident["ce_recovered_A"],
                                      "B": ident["ce_recovered_B"]},
        "oracle_zero_recovered": {"A": zero["ce_recovered_A"], "B": zero["ce_recovered_B"]},
    }
    ok = all(
        abs(out["oracle_identity_recovered"][m] - 1) < 1e-3
        # the zero reconstruction is a floor, not exactly 0: the splice
        # keeps BOS clean while the ablation zeroes it too
        and out["oracle_zero_recovered"][m] < 0.5
        and out[f"ce_recovered_{m}"] > 0.6
        # a good reconstruction can denoise a little, so spliced CE may dip
        # below clean: the ceiling is loose
        and out[f"ce_recovered_{m}"] <= 1.02
        # the ablation must hurt, or "recovered" is vacuous
        and out[f"ce_zero_abl_{m}"] - out[f"ce_clean_{m}"] > 0.5
        for m in "AB")
    band_checked = ((args.demo_lm_steps, args.demo_cc_steps) == DEMO_DEFAULT_STEPS
                    and dev.type == DEMO_EXPECTED_DEVICE)
    out["device"] = dev.type
    out["expected_device"] = DEMO_EXPECTED_DEVICE
    out["expected_recovered"] = DEMO_EXPECTED_RECOVERED
    out["distance_from_expected"] = {
        m: abs(out[f"ce_recovered_{m}"] - DEMO_EXPECTED_RECOVERED[m]) for m in "AB"}
    out["expected_band"] = DEMO_BAND
    out["band_checked"] = band_checked
    if band_checked:
        # the zero floor sits well below 0 there; one creeping toward the
        # trained value would make "recovered" vacuous
        ok = ok and all(out["distance_from_expected"][m] <= DEMO_BAND
                        and out["oracle_zero_recovered"][m] < 0.0 for m in "AB")
    out["gate_pass"] = bool(ok)
    return out


def main(argv=None, device=None) -> dict:
    """Run the gate from ``argv``; ``device`` (else ``--device``, else
    ``cuda``) is where the models and the crosscoder run."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--hf", action="store_true", help="published HF checkpoint")
    mode.add_argument("--version-dir", type=str, help="local checkpoint dir")
    mode.add_argument("--demo", action="store_true", help="air-gapped gate demo")
    ap.add_argument("--save", type=int, default=None)
    ap.add_argument("--model-a", type=str, default="google/gemma-2-2b",
                    help="local HF checkpoint directory of model A")
    ap.add_argument("--model-b", type=str, default="google/gemma-2-2b-it",
                    help="local HF checkpoint directory of model B")
    ap.add_argument("--tokens", type=str, default=None, help=".npy or .pt token array")
    ap.add_argument("--n-seqs", type=int, default=None)
    ap.add_argument("--chunk", type=int, default=4)
    ap.add_argument("--norm-factors", type=str, default=None, help="a,b fold factors")
    # the defaults are the recorded run's (band_checked compares with them)
    ap.add_argument("--demo-lm-steps", type=positive_int, default=DEMO_DEFAULT_STEPS[0])
    ap.add_argument("--demo-cc-steps", type=positive_int, default=DEMO_DEFAULT_STEPS[1])
    ap.add_argument("--out", type=str, default=None, help="write metrics JSON here")
    ap.add_argument("--device", type=str, default=None, help="torch device (default cuda)")
    args = ap.parse_args(argv)
    if not args.demo and not args.hf and not args.tokens:
        ap.error("--tokens is required with --version-dir")
    device = device or args.device
    metrics = run_demo(args, device) if args.demo else run_real(args, device)
    print(  # contracts: allow(lint-no-stdout-print) — the CLI's result document
        json.dumps(metrics, indent=2))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(metrics, indent=2))
        print(f"wrote {args.out}", file=sys.stderr)
    return metrics


if __name__ == "__main__":
    main()
