"""Metrics registry: counters, gauges, EMA timers and bounded histograms,
ported from :mod:`crosscoder_tpu.obs.registry`.

Thread-safe from any thread (the train loop, the prefetch worker, the
checkpoint writer and the watchdog's runners record at once); an untouched
registry snapshots to ``{}``. Keys are full metric names
(``serve/prefill_ms``, ``perf/step_ms``, ``comm/h2d_transfers``, ...).
Snapshot forms:

- ``count(k)``: monotone counter → ``{k: int}`` (zero counts dropped);
- ``gauge(k, v)``: last value → ``{k: v}``;
- ``ema(k, v)``: exponential moving average → ``{k: v}``;
- ``observe(k, v)``: the last ``HIST_CAP`` observations →
  ``{k_p50, k_p99, k_max, k_n}``.
"""

from __future__ import annotations

import threading


class MetricsRegistry:
    HIST_CAP = 4096     # observations kept per histogram (ring buffer)
    EMA_ALPHA = 0.1     # ~ the last 10 observations dominate

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counts: dict[str, int] = {}
        self._gauges: dict[str, float] = {}
        self._emas: dict[str, float] = {}
        self._hists: dict[str, list[float]] = {}
        self._hist_pos: dict[str, int] = {}

    def count(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._counts[key] = self._counts.get(key, 0) + n

    def gauge(self, key: str, value: float) -> None:
        with self._lock:
            self._gauges[key] = float(value)

    def ema(self, key: str, value: float, alpha: float | None = None) -> None:
        a = self.EMA_ALPHA if alpha is None else alpha
        with self._lock:
            prev = self._emas.get(key)
            self._emas[key] = float(value) if prev is None else (
                (1.0 - a) * prev + a * float(value))

    def get_count(self, key: str) -> int:
        with self._lock:
            return self._counts.get(key, 0)

    def get_gauge(self, key: str) -> float | None:
        with self._lock:
            return self._gauges.get(key)

    def observe(self, key: str, value: float) -> None:
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = []
                self._hist_pos[key] = 0
            if len(h) < self.HIST_CAP:
                h.append(float(value))
            else:                       # ring overwrite: keep the newest CAP
                h[self._hist_pos[key]] = float(value)
                self._hist_pos[key] = (self._hist_pos[key] + 1) % self.HIST_CAP
            self._counts[f"{key}_n"] = self._counts.get(f"{key}_n", 0) + 1

    def snapshot(self) -> dict[str, float]:
        """Flat scalar view; ``{}`` when untouched."""
        with self._lock:
            out: dict[str, float] = {k: v for k, v in self._counts.items() if v}
            out.update(self._gauges)
            out.update(self._emas)
            for k, h in self._hists.items():
                if not h:
                    continue
                s = sorted(h)
                out[f"{k}_p50"] = s[len(s) // 2]
                out[f"{k}_p99"] = s[min(len(s) - 1, (len(s) * 99) // 100)]
                out[f"{k}_max"] = s[-1]
            return out
