"""Metrics logging, ported from :mod:`crosscoder_tpu.utils.logging`.

The logger is selected by ``cfg.log_backend``:

- ``jsonl``: one JSON object per log call appended to
  ``<checkpoint_dir>/metrics.jsonl``;
- ``null``: drop everything;
- ``wandb``: wandb when it is importable and ``cfg.wandb_project`` is set
  (raises otherwise);
- ``auto``: wandb if usable, else jsonl (with a note on stderr).

The logged scalars are the reference's surface (``trainer.py:51-61``):
loss, l2_loss, l1_loss, l0_loss, l1_coeff, lr, explained_variance and
``explained_variance_<tag>`` per source (A/B for the reference pair).
The human echo goes to stderr every ``cfg.log_print_every`` logs.
:class:`ResilienceCounters` feeds the ``resilience/*`` channel: the
trainer's recoveries (rollbacks, skipped batches, poisoned saves), logged
only once one has happened.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from pathlib import Path
from typing import Any

_LETTERS = "ABCDEFGH"


class ResilienceCounters:
    """Monotone recovery counters (the ``resilience/*`` metric channel),
    bumped from whichever thread recovered a fault. :meth:`snapshot`
    returns the nonzero counters under ``resilience/<name>`` keys; an
    untouched instance snapshots to ``{}``, so a run with no faults logs
    exactly the reference's scalar surface."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counts: dict[str, int] = {}

    def bump(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n

    def get(self, name: str) -> int:
        with self._lock:
            return self._counts.get(name, 0)

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            return {f"resilience/{k}": v for k, v in self._counts.items() if v}


def source_tag(i: int) -> str:
    """Source index → metric-name suffix: A/B for the reference pair
    (``explained_variance_A``/``_B``), letters through H, then the index."""
    return _LETTERS[i] if i < len(_LETTERS) else str(i)


class MetricsLogger:
    def __init__(self, cfg) -> None:
        self.cfg = cfg
        backend = cfg.log_backend
        self._wandb = None
        if backend == "wandb" and not cfg.wandb_project:
            raise ValueError("log_backend='wandb' requires cfg.wandb_project")
        if backend in ("auto", "wandb") and cfg.wandb_project:
            try:
                import wandb  # type: ignore

                wandb.init(project=cfg.wandb_project, entity=cfg.wandb_entity or None)
                self._wandb = wandb
                backend = "wandb"
            except Exception as e:  # not installed, offline, no credentials
                if cfg.log_backend == "wandb":
                    raise
                print(f"[crosscoder_tpu_torch] wandb unavailable ({e}); falling back to jsonl",
                      file=sys.stderr)
                backend = "jsonl"
        elif backend == "auto":
            backend = "jsonl"
        self.backend = backend
        self._file = None
        if backend == "jsonl":
            path = Path(cfg.checkpoint_dir)
            path.mkdir(parents=True, exist_ok=True)
            self._file = open(path / "metrics.jsonl", "a", buffering=1)
        self._n_logs = 0
        self._skipped_keys: set[str] = set()

    def log(self, metrics: dict[str, Any], step: int) -> None:
        scalars: dict[str, float] = {}
        for k, v in metrics.items():
            try:
                scalars[k] = float(v)
            except (TypeError, ValueError):
                if k not in self._skipped_keys:
                    self._skipped_keys.add(k)
                    print(f"[crosscoder_tpu_torch] MetricsLogger: skipping non-scalar "
                          f"metric {k!r} ({type(v).__name__}); further occurrences silent",
                          file=sys.stderr, flush=True)
        if self.backend == "wandb" and self._wandb is not None:
            self._wandb.log(scalars, step=step)
        elif self._file is not None:
            self._file.write(json.dumps({"step": step, "time": time.time(), **scalars}) + "\n")
        every = getattr(self.cfg, "log_print_every", 1)
        if self.backend != "null" and every and self._n_logs % every == 0:
            print({"step": step, **{k: round(v, 6) for k, v in scalars.items()}},
                  file=sys.stderr)
        self._n_logs += 1

    def close(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()
        if self._file is not None:
            self._file.close()
            self._file = None
