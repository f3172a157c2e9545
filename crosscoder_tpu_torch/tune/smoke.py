"""Tuner smoke: a tiny lattice, the calibration windows, one artifact, end
to end through the real search; ported from :mod:`crosscoder_tpu.tune.smoke`.

    python -m crosscoder_tpu_torch.tune.smoke [--device cpu]

runs the whole two-stage tune at a tiny shape (8 valid candidates over 3
data-plane knobs, the top 2 and the default calibrated), checks that the
winner's ``TUNED.json`` was written, reloads it through
:func:`~crosscoder_tpu_torch.tune.artifact.load_tuned` and
:func:`~crosscoder_tpu_torch.tune.artifact.apply_tuned`, and checks that
the applied config carries exactly the pinned knobs. Runs on ``cuda``
unless ``--device`` names another device. Exit 0 on success, 1 on any
failure.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile


def main(argv: list[str] | None = None) -> int:
    from crosscoder_tpu_torch.config import CrossCoderConfig
    from crosscoder_tpu_torch.tune import apply_tuned, load_tuned, tune

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="the device to tune on (default: cuda)")
    args = ap.parse_args(argv)
    root = os.environ.get("TUNE_SMOKE_DIR") or tempfile.mkdtemp(prefix="tune_smoke_")
    cfg = CrossCoderConfig(
        d_in=8, dict_size=32, batch_size=32, enc_dtype="fp32",
        num_tokens=10**9, save_every=10**9, log_backend="null",
        checkpoint_dir=os.path.join(root, "ckpt"),
    )
    axes = {
        "prefetch": (False, True),
        "refill_frac": (0.25, 0.5),
        "refill_dispatch_batch": (4, 8),
    }
    out_path = os.path.join(root, "TUNED.json")
    art = tune(cfg, "train", axes=axes, top_k=2, out_path=out_path, steps=3, warmup=1, seed=0,
               device=args.device)

    if not os.path.exists(out_path):
        print("tune smoke: TUNED.json was not written", file=sys.stderr)
        return 1
    reloaded = load_tuned(out_path)                 # raises if malformed
    if reloaded.knobs != art.knobs:
        print(f"tune smoke: reloaded knobs {reloaded.knobs} != emitted {art.knobs}",
              file=sys.stderr)
        return 1
    applied = apply_tuned(cfg, out_path)
    bad = {k: (getattr(applied, k), v) for k, v in art.knobs.items() if getattr(applied, k) != v}
    if bad:
        print(f"tune smoke: applied config disagrees with artifact: {bad}", file=sys.stderr)
        return 1
    if art.search["n_candidates"] < 8 or len(art.search["axes"]) < 3:
        print(f"tune smoke: lattice too small ({art.search['n_candidates']} candidates over "
              f"{len(art.search['axes'])} knobs)", file=sys.stderr)
        return 1
    print(f"tune smoke: OK — {art.search['n_candidates']} candidates, winner "
          f"{sorted(art.knobs.items())}, artifact {out_path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
