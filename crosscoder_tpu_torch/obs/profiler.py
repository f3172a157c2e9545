"""Windowed device profiling: ``torch.profiler`` traces of exactly N steps,
ported from :mod:`crosscoder_tpu.obs.profiler`.

- ``cfg.profile_steps="start:stop"`` captures the absolute steps
  ``[start, stop)``;
- ``SIGUSR1`` (installed by the Trainer when the plane or a window is
  configured; main thread only) captures ``SIG_WINDOW_STEPS`` steps from
  the next one (``kill -USR1 <pid>``), without a restart;
- with neither, a non-empty ``profile_dir`` keeps the legacy window:
  steps ``LEGACY_START`` to ``LEGACY_START + LEGACY_LEN`` of each stretch.

A window captures with :class:`torch.profiler.profile`: CPU and CUDA
activities on the card, the CPU alone on a CPU device. Each window writes
one Chrome trace, ``window<n>_steps_<first>-<last>.trace.json``, under
``cfg.profile_dir`` or else ``<obs_dir>/profile``. Before the stop the
device is synchronized, so the work the window launched lands in it. The
host spans of :mod:`crosscoder_tpu_torch.obs.trace` appear there as
``record_function`` ranges over the kernels they launched.

One profiler may run in a process at a time: :meth:`stop_if_active` ends
a window left open by a rollback or the loop's exit.

As a window closes, the card's memory lands in the registry (when one is
given): ``perf/hbm_bytes_in_use`` (``torch.cuda.memory_allocated``),
``perf/hbm_peak_bytes`` (``max_memory_allocated``) and
``perf/hbm_bytes_limit`` (``mem_get_info()[1]``, the card's total), with
``perf/profile_windows`` counting windows. A CPU device records no memory
gauge.
"""

from __future__ import annotations

import os
import signal
import threading
from pathlib import Path
from typing import Any

import torch


def parse_profile_steps(spec: str) -> tuple[int, int] | None:
    """``"start:stop"`` → ``(start, stop)``, validated; ``""`` → None."""
    if not spec:
        return None
    parts = spec.split(":")
    if len(parts) != 2 or not all(p.strip().lstrip("-").isdigit() for p in parts):
        raise ValueError(f"profile_steps must be 'start:stop' (two integers), got {spec!r}")
    start, stop = int(parts[0]), int(parts[1])
    if start < 0 or stop <= start:
        raise ValueError(
            f"profile_steps needs 0 <= start < stop, got {spec!r}; the "
            f"window captures steps [start, stop)")
    return start, stop


class ProfilerWindow:
    """The profiling windows of one run: the trainer calls :meth:`before_step` and
    :meth:`after_step` around every step (a few comparisons when no window
    is configured or pending). ``device``: where the steps run (the CUDA
    activity, the sync before a stop and the memory gauges are the card's)."""

    LEGACY_START = 10       # the historical profile_dir window, kept
    LEGACY_LEN = 5
    SIG_WINDOW_STEPS = 5    # steps captured per SIGUSR1

    def __init__(self, cfg: Any, registry: Any | None = None, device=None) -> None:
        self.out_dir = cfg.profile_dir or os.path.join(
            cfg.obs_dir or os.path.join(cfg.checkpoint_dir, "obs"), "profile")
        self.registry = registry
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        self._window = parse_profile_steps(cfg.profile_steps)
        self._legacy = self._window is None and bool(cfg.profile_dir)
        self._resolved: tuple[int, int] | None = self._window
        self._pending_sig = 0           # SIGUSR1-requested steps
        self._active = False
        self._prof = None
        self._steps: list[int] = []     # the steps of the window in capture
        self.windows_captured = 0
        self.paths: list[Path] = []     # each window's trace
        self._prev_handler: Any = None

    @property
    def configured(self) -> bool:
        """True when this run can ever capture (a window or the legacy dir)."""
        return self._window is not None or self._legacy

    # -- stretch/loop hooks ---------------------------------------------------
    def begin_stretch(self, start: int) -> None:
        """Resolve the legacy window against the stretch's first step; an
        absolute ``profile_steps`` window is left alone, so a rollback that
        re-enters the loop does not arm again a window already captured."""
        if self._legacy:
            self._resolved = (start + self.LEGACY_START,
                              start + self.LEGACY_START + self.LEGACY_LEN)

    def request_window(self, n_steps: int | None = None) -> None:
        """Arm an on-demand window from the next step (what SIGUSR1 calls)."""
        self._pending_sig = n_steps or self.SIG_WINDOW_STEPS

    def before_step(self, step: int) -> None:
        if self._active:
            self._steps.append(step)
            return
        if self._resolved is not None and step > self._resolved[0]:
            # its start passed unfired (a restore landed past it): a stale
            # window must not block an on-demand capture for ever
            self._resolved = None
        if self._pending_sig and self._resolved is None:
            # an on-demand window starts at this step; a configured window
            # still pending goes first and the request stays armed
            self._resolved = (step, step + self._pending_sig)
            self._pending_sig = 0
        if self._resolved is not None and step == self._resolved[0]:
            self._start()
            self._steps = [step]

    def after_step(self, step: int) -> None:
        if self._active and self._resolved is not None and step >= self._resolved[1] - 1:
            self._stop()
            self._resolved = None       # a one-shot window is consumed

    def stop_if_active(self) -> None:
        """End a capture in flight (a rollback, the loop's exit): a
        profiler left running makes the next window's start raise."""
        if self._active:
            self._stop()
            self._resolved = None

    def _start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.start()
        self._active = True

    def _stop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)     # the window's kernels land in it
        prof, self._prof = self._prof, None
        self._active = False
        prof.stop()
        first, last = self._steps[0], self._steps[-1]
        path = Path(self.out_dir) / f"window{self.windows_captured}_steps_{first}-{last}.trace.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(path))
        self.paths.append(path)
        self.windows_captured += 1
        if self.registry is not None:
            self.registry.count("perf/profile_windows")
            self.record_memory_gauges()

    # -- device memory gauges -------------------------------------------------
    def record_memory_gauges(self) -> None:
        """The card's memory into the registry; nothing on a CPU device."""
        if self.registry is None or self.device.type != "cuda":
            return
        r = self.registry
        r.gauge("perf/hbm_bytes_in_use", torch.cuda.memory_allocated(self.device))
        r.gauge("perf/hbm_peak_bytes", torch.cuda.max_memory_allocated(self.device))
        r.gauge("perf/hbm_bytes_limit", torch.cuda.mem_get_info(self.device)[1])

    # -- SIGUSR1 --------------------------------------------------------------
    def install_sigusr1(self) -> bool:
        """Arm a window on SIGUSR1; main thread only (the signal module's
        rule). True when installed; :meth:`uninstall_sigusr1` restores the
        previous handler."""
        if threading.current_thread() is not threading.main_thread():
            return False

        def _on_sig(signum, frame):
            self.request_window()

        self._prev_handler = signal.signal(signal.SIGUSR1, _on_sig)
        return True

    def uninstall_sigusr1(self) -> None:
        if self._prev_handler is not None:
            signal.signal(signal.SIGUSR1, self._prev_handler)
            self._prev_handler = None
