"""Replication walkthrough, ported from ``scripts/replicate.py``: the
reference notebook's acceptance sequence (nb:cells 13-42) as one command,
with a pass/fail comparison against the published values (BASELINE.md):
  checkpoint → 3-cluster relative-norm histogram → shared-latent cosine
  stats → CE-recovered table → firing rates → feature dashboards

Modes::
    # air-gapped: trains the deterministic demo pair and a crosscoder
    python -m crosscoder_tpu_torch.replicate --demo --out replicate_demo

    # a locally trained checkpoint; CE, firing rates and dashboards need
    # both models as local HF directories, tokens and the norm factors
    python -m crosscoder_tpu_torch.replicate --version-dir checkpoints/version_0 \\
        --model-a ./gemma-2-2b --model-b ./gemma-2-2b-it --tokens tokens.npy \\
        --norm-factors 0.2759,0.2442 --out out

Runs on ``cuda`` unless ``--device`` (or ``main(device=...)``) names
another device. ``--hf`` (the published checkpoint and Gemma-2-2B pair)
needs downloads and is not ported. Writes ``replicate_report.json`` (the
keys ``scripts/replicate.py`` writes) and ``dashboards.html`` under
``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from crosscoder_tpu_torch import demo
from crosscoder_tpu_torch.analysis import ce_eval
from crosscoder_tpu_torch.analysis.dashboards import FeatureVisConfig, FeatureVisData
from crosscoder_tpu_torch.analysis.decoder import (
    cosine_sims, dead_latent_fraction, decoder_norms, firing_rates, relative_norm_histogram,
    relative_norms, shared_latent_mask,
)
from crosscoder_tpu_torch.checkpoint import Checkpointer
from crosscoder_tpu_torch.models import crosscoder as cc
from crosscoder_tpu_torch.models import lm
from crosscoder_tpu_torch.utils.device import resolve_device

PUBLISHED = {
    "ce_recovered_A": 0.921875,
    "ce_recovered_B": 0.92578125,
    "norm_factor_A": 0.2758961493232058,
    "norm_factor_B": 0.24422852496546169,
}


# --hf (the published checkpoint and model pair) needs downloads
HF_NOT_PORTED = (
    "--hf needs the published crosscoder and the Gemma-2-2B pair from the hub: "
    "crosscoder_tpu/checkpoint/torch_compat.py load_from_hf (hf_hub_download) is not "
    "ported, and the port downloads nothing; use --version-dir with local weights, or --demo")


def decoder_stage(params) -> dict:
    """The 3-cluster histogram counts and the shared-latent cosine stats
    (reference ``analysis.py:9-58``, nb:cells 13-22)."""
    r = relative_norms(params).cpu().numpy()
    shared = shared_latent_mask(params).cpu().numpy()
    cos = cosine_sims(params).cpu().numpy()[shared]
    counts, edges = relative_norm_histogram(params)
    return {
        "d_hidden": int(r.shape[0]),
        "cluster_A_only": int((r <= 0.3).sum()),
        "cluster_shared": int(shared.sum()),
        "cluster_B_only": int((r >= 0.7).sum()),
        "three_clusters_present": bool(
            (r <= 0.3).sum() > 0 and shared.sum() > 0 and (r >= 0.7).sum() > 0),
        "shared_cosine_median": float(np.median(cos)) if cos.size else None,
        "shared_cosine_frac_gt_0.95": float((cos > 0.95).mean()) if cos.size else None,
        "histogram": {"counts": counts.cpu().tolist(), "edges": edges.cpu().tolist()},
    }


def ce_stage(tokens, lm_cfg, model_params, hook_point, folded_params, cfg, chunk=4) -> dict:
    return ce_eval.get_ce_recovered_metrics(
        tokens, lm_cfg, model_params, hook_point,
        ce_eval.crosscoder_reconstruct_fn(folded_params, cfg), chunk=chunk)


def firing_stage(folded_params, cfg, lm_cfg, model_params, tokens, hook_point) -> dict:
    """Whole-dictionary feature density: firing rates over the harvested
    rows of the first 16 sequences (post-BOS, as harvested) and the
    dead-latent fraction. Folded params take raw rows."""
    toks = tokens[:16]
    n_models = len(model_params)
    dev = model_params[0]["embed"].device

    def row_batches(chunk=4):
        for start in range(0, toks.shape[0], chunk):
            acts = lm.run_with_cache_multi(
                model_params, torch.as_tensor(toks[start:start + chunk], device=dev),
                lm_cfg, (hook_point,))
            yield acts[:, 1:].reshape(-1, n_models, lm_cfg.d_model)

    rates = firing_rates(folded_params, cfg, row_batches())
    return {
        "n_rows": int(toks.shape[0] * (toks.shape[1] - 1)),
        "dead_latent_frac": dead_latent_fraction(rates),
        "median_rate": float(np.median(rates)),
        "p95_rate": float(np.percentile(rates, 95)),
    }


def dashboards_stage(folded_params, cfg, lm_cfg, model_params, tokens, hook_point, features,
                     out_dir: Path, tokenizer=None) -> dict:
    vis_cfg = FeatureVisConfig(hook_point=hook_point, features=tuple(features))
    data = FeatureVisData.create(folded_params, cfg, lm_cfg, model_params, tokens, vis_cfg)
    path = data.save_feature_centric_vis(out_dir / "dashboards.html", tokenizer=tokenizer)
    doc = path.read_text()
    return {
        "path": str(path),
        "bytes": len(doc),
        "cards": doc.count('class="card"'),
        "has_logit_lens": "promoted:" in doc,
    }


def pick_features(params, k: int = 4) -> list[int]:
    """A mix the notebook browses: the strongest A-only, shared and B-only
    latents by summed decoder norm, ``max(1, k // 3)`` of each."""
    r = relative_norms(params).cpu().numpy()
    w = decoder_norms(params).sum(-1).cpu().numpy()
    picks = []
    for mask in (r <= 0.3, (r > 0.3) & (r < 0.7), r >= 0.7):
        idx = np.flatnonzero(mask)
        if idx.size:
            picks.extend(idx[np.argsort(-w[idx])][: max(1, k // 3)].tolist())
    return picks[:k] or [0]


def compare(report: dict) -> dict:
    """Pass/fail against BASELINE.md where the run produced comparable
    numbers."""
    checks = {}
    ce = report.get("ce", {})
    if report.get("mode") == "hf" and "ce_recovered_A" in ce:
        checks["ce_recovered_A_within_0.01"] = bool(
            abs(ce["ce_recovered_A"] - PUBLISHED["ce_recovered_A"]) < 0.01)
        checks["ce_recovered_B_within_0.01"] = bool(
            abs(ce["ce_recovered_B"] - PUBLISHED["ce_recovered_B"]) < 0.01)
    dec = report.get("decoder", {})
    if dec:
        checks["three_clusters_present"] = dec["three_clusters_present"]
        if dec["shared_cosine_median"] is not None:
            # nb:cells 21-22: shared-latent cosines concentrate near 1
            checks["shared_cosines_concentrate_high"] = bool(dec["shared_cosine_median"] > 0.8)
    if "ce_recovered_A" in ce:
        checks["ce_recovered_far_above_zero_floor"] = bool(
            ce["ce_recovered_A"] > 0.6 and ce["ce_recovered_B"] > 0.6)
    dash = report.get("dashboards", {})
    if dash:
        checks["dashboards_written"] = bool(dash["bytes"] > 2000 and dash["cards"] > 0)
    checks["all_pass"] = all(checks.values())
    return checks


def load_tokens(path: str) -> np.ndarray:
    """A token matrix from a ``.npy`` file or a ``torch.save``d tensor."""
    if path.endswith(".npy"):
        return np.load(path)
    return torch.load(path, map_location="cpu").numpy()


def run(args, device=None) -> dict:
    dev = resolve_device(device)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    report: dict = {}

    if args.hf:
        raise NotImplementedError(HF_NOT_PORTED)
    if args.demo:
        report["mode"] = "demo (air-gapped; synthetic-language pair)"
        print("[replicate] training demo LM pair + crosscoder ...", file=sys.stderr, flush=True)
        lm_cfg, model_params, tokens, lm_ces = demo.build_demo_pair(args.demo_lm_steps,
                                                                    device=dev)
        params, cfg, factors, final = demo.train_demo_crosscoder(
            lm_cfg, model_params, tokens, args.demo_cc_steps, device=dev)
        hook = demo.DEMO_HOOK
        eval_tokens = tokens[: args.n_seqs or 64]
        report["lm_train_ce"] = lm_ces
        report["crosscoder_final"] = {k: float(v) for k, v in final.items()}
    else:
        report["mode"] = "local"
        params, cfg = Checkpointer.load_weights(args.version_dir, args.save, device=dev)
        factors = (np.asarray([float(x) for x in args.norm_factors.split(",")], np.float32)
                   if args.norm_factors else None)
        hook = cfg.hook_point
        lm_cfg = model_params = eval_tokens = None
        if args.tokens:
            params_a, lm_cfg = lm.from_hf(args.model_a, device=dev)
            model_params = [params_a, lm.from_hf(args.model_b, lm_cfg, device=dev)[0]]
            tok = load_tokens(args.tokens)
            eval_tokens = tok[: args.n_seqs] if args.n_seqs else tok

    print("[replicate] stage 1-2: decoder-space analysis ...", file=sys.stderr, flush=True)
    report["decoder"] = decoder_stage(params)

    folded = None
    if factors is not None:
        folded = cc.fold_scaling_factors(params, factors)
        report["norm_factors"] = [float(x) for x in np.asarray(factors)]

    if folded is not None and eval_tokens is not None and model_params is not None:
        print("[replicate] stage 3: CE-recovered table ...", file=sys.stderr, flush=True)
        report["ce"] = ce_stage(eval_tokens, lm_cfg, model_params, hook, folded, cfg,
                                chunk=args.chunk)
        print("[replicate] stage 4: firing rates ...", file=sys.stderr, flush=True)
        report["firing"] = firing_stage(folded, cfg, lm_cfg, model_params, eval_tokens, hook)
        print("[replicate] stage 5: dashboards ...", file=sys.stderr, flush=True)
        report["dashboards"] = dashboards_stage(
            folded, cfg, lm_cfg, model_params, eval_tokens, hook, pick_features(params),
            out_dir, tokenizer=args.tokenizer)
    else:
        report["ce"] = {}
        report["firing"] = {}
        report["dashboards"] = {}
        report["skipped"] = ("CE/firing-rates/dashboards need LM weights + tokens (--tokens, "
                             "and --norm-factors for --version-dir)")

    report["published"] = PUBLISHED
    report["checks"] = compare(report)
    return report


def positive_int(s: str) -> int:
    v = int(s)
    if v < 1:
        raise argparse.ArgumentTypeError("must be >= 1")
    return v


def main(argv=None, device=None) -> dict:
    """Run the walkthrough from ``argv``; ``device`` (else ``--device``,
    else ``cuda``) is where the models and the crosscoder run."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--hf", action="store_true")
    mode.add_argument("--version-dir", type=str)
    mode.add_argument("--demo", action="store_true")
    ap.add_argument("--save", type=int, default=None)
    ap.add_argument("--model-a", type=str, default="google/gemma-2-2b",
                    help="local HF checkpoint directory of model A")
    ap.add_argument("--model-b", type=str, default="google/gemma-2-2b-it",
                    help="local HF checkpoint directory of model B")
    ap.add_argument("--tokens", type=str, default=None)
    ap.add_argument("--n-seqs", type=int, default=None)
    ap.add_argument("--chunk", type=int, default=4)
    ap.add_argument("--norm-factors", type=str, default=None)
    ap.add_argument("--tokenizer", type=str, default=None,
                    help="local HF tokenizer.json (or its dir): dashboards "
                         "render real text instead of ⟨id⟩ placeholders")
    ap.add_argument("--demo-lm-steps", type=positive_int, default=400)
    ap.add_argument("--demo-cc-steps", type=positive_int, default=1500)
    ap.add_argument("--out", type=str, default="replicate_out")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)

    report = run(args, device=device or args.device)
    out_dir = Path(args.out)
    (out_dir / "replicate_report.json").write_text(json.dumps(report, indent=2))
    print(  # contracts: allow(lint-no-stdout-print) — the CLI's result document
        json.dumps({k: v for k, v in report.items() if k != "decoder"}
                   | {"decoder": {k: v for k, v in report["decoder"].items()
                                  if k != "histogram"}}, indent=2))
    print(f"\nwrote {out_dir}/replicate_report.json", file=sys.stderr)
    print(  # contracts: allow(lint-no-stdout-print) — one-line verdict
        "PASS" if report["checks"]["all_pass"] else "FAIL", "—", json.dumps(report["checks"]))
    return report


if __name__ == "__main__":
    main()
