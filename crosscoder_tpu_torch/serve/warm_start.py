"""Warm-start probe: one serve warmup against the persistent compile tier,
ported from :mod:`crosscoder_tpu.serve.warm_start`.

``python -m crosscoder_tpu_torch.serve.warm_start --cache-dir D`` builds the
serving stack of :func:`crosscoder_tpu_torch.serve.smoke.build_engine` with
``compile_cache_dir=D`` on the card, runs :meth:`InferenceEngine.warmup`
(which acquires every kernel library through the tier) and prints ONE JSON
line to stdout::

    {"warm_start": {"warmup_ms": ..., "compiles": N, "disk_hits": N,
                    "disk_misses": N, "disk_entries": N,
                    "zero_compiles": bool}}

``compiles`` counts the ``nvcc`` runs of the warmup. Run it twice against
the same directory from two separate processes and the second run reports
``compiles == 0``: every library loads from the tier. ``--device cpu`` runs
the stack's plain paths, which build nothing.
"""

from __future__ import annotations

import json
import sys
import time


def run(cache_dir: str, *, serve_max_batch: int = 8, seq_len: int = 16,
        return_engine: bool = False, **overrides):
    """Build and warm one engine against ``cache_dir``; return the report
    dict (and the engine too, as ``(report, engine)``, with
    ``return_engine``). ``overrides`` go to
    :func:`~crosscoder_tpu_torch.serve.smoke.build_engine`: its keywords
    (``lm_cfg``, ``hook_points``, ``device``, ``seeds``) and config fields,
    so the card can run it at full width."""
    from crosscoder_tpu_torch.serve.smoke import build_engine
    from crosscoder_tpu_torch.utils import compile_cache

    eng, _cfg, _lm_cfg, _params, _cc = build_engine(
        serve_max_batch=serve_max_batch, seq_len=seq_len,
        compile_cache_dir=cache_dir, **overrides)
    t0 = time.perf_counter()
    n_compiles = eng.warmup()
    warmup_ms = (time.perf_counter() - t0) * 1e3
    stats = compile_cache.disk_stats()
    report = {
        "warmup_ms": round(warmup_ms, 1),
        "compiles": int(n_compiles),
        "disk_hits": int(stats.get("disk_hit", 0)),
        "disk_misses": int(stats.get("disk_miss", 0)),
        "disk_entries": compile_cache.disk_entry_count(),
        "zero_compiles": int(n_compiles) == 0,
    }
    return (report, eng) if return_engine else report


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cache-dir", required=True,
                    help="persistent compile cache directory (cfg.compile_cache_dir)")
    ap.add_argument("--expect-zero-compiles", action="store_true",
                    help="exit nonzero unless the warmup ran no nvcc (the "
                         "warm-process assertion)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the plain paths)")
    ns = ap.parse_args(argv)

    report = run(ns.cache_dir, device=ns.device)
    print(  # contracts: allow(lint-no-stdout-print) — one-line report
        json.dumps({"warm_start": report}), flush=True)
    if ns.expect_zero_compiles and not report["zero_compiles"]:
        print(f"[warm_start] FAIL: expected zero compiles, got {report['compiles']}",
              file=sys.stderr, flush=True)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
