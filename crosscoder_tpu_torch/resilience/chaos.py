"""Deterministic fault injection for the training stack, ported from
:mod:`crosscoder_tpu.resilience.chaos`.

A :class:`Chaos` object is a set of faults planned by monotone event
counters (serve index, harvest-chunk index, save version), so one spec
gives the same faults in every run. Each planned fault fires exactly once:
after a rollback rewinds the step counter, the replayed stretch is clean
(a transient fault); a fault that comes back on every replay is a bug and
is meant to spend the retry budget and abort.

Injection points, each behind a ``chaos is not None`` check at its site:

- ``on_serve`` / ``poison_batch``: the trainer's batch production: stall,
  raise :class:`ChaosFault`, SIGTERM or ``os._exit`` at serve N, or set row
  0 of serve N's batch to NaN/Inf (in a copy, or in the trainer's own
  staging tensor: never in a store's rows);
- ``on_harvest``: the start of the buffer's ``_harvest_job``: stall or
  raise by harvest-chunk index;
- ``corrupt_save``: the checkpointer's writer, once a save's meta marker
  lands: truncate or flip a byte of one artifact of save V.

Enable with ``cfg.chaos`` or the ``CROSSCODER_CHAOS`` environment variable,
a comma-separated spec (:meth:`Chaos.parse`), e.g.::

    nan@5,corrupt-save@0:weights,stall@12:2.5,seed=7

Grammar (``N`` an event index, ``SEC`` float seconds):

- ``nan@N`` / ``inf@N``     — poison the batch of serve N
- ``stall@N[:SEC]``         — stall serve N (default 30 s)
- ``preempt@N``             — SIGTERM to self at serve N
- ``die@N``                 — ``os._exit(43)`` at serve N
- ``fail@N``                — raise ChaosFault at serve N
- ``return@N``              — a killed host returns at serve N (the
  elastic scale-up's fault: the trainer opens the rejoin window)
- ``flaky@N:P``             — from liveness probe N on, skip each probe
  with probability P (seeded per probe; a property, not fire-once)
- ``slow@N:MS``             — join probe N's barrier MS ms late
- ``stall-harvest@N[:SEC]`` — stall harvest chunk N
- ``fail-harvest@N``        — raise ChaosFault at harvest chunk N
- ``corrupt-save@V[:KIND]`` — corrupt save V's artifact; KIND in
  ``weights`` (default) | ``state`` | ``cfg`` | ``meta``
- ``mode=truncate|flipbyte`` — corruption mode (default truncate)
- ``seed=N``                — seed of the flip offset and of the flaky
  miss pattern

The probe faults (``flaky@``, ``slow@``) and ``return@`` parse and render,
and :meth:`Chaos.on_probe` / :meth:`Chaos.take_return` answer as the JAX
package's; the elastic controller calls :meth:`Chaos.on_probe` at each
liveness probe, and the trainer's serve :meth:`Chaos.take_return`, which
opens the rejoin window of an elastic grow. :meth:`Chaos.render` is the grammar's inverse: a canonical spec
that parses back to the same plan.
"""

from __future__ import annotations

import sys
import threading
import time
from pathlib import Path
from typing import Any

import numpy as np

_ARTIFACTS = {
    "weights": "{v}.npz",
    "state": "{v}_train_state.npz",
    "cfg": "{v}_cfg.json",
    "meta": "{v}_meta.json",
}

_DEFAULT_STALL_S = 30.0

# dedicated seed stream for the flaky@ probe-miss pattern, so it can never
# collide with the corrupt-save flip-offset stream at the same seed
_FLAKY_STREAM = 104729


class ChaosFault(RuntimeError):
    """The exception an injected ``fail@``/``fail-harvest@`` fault raises."""


class Chaos:
    """Planned fault schedule + the fire-once state machine around it."""

    def __init__(
        self,
        nan_serves: tuple[int, ...] = (),
        inf_serves: tuple[int, ...] = (),
        stall_serves: dict[int, float] | None = None,
        fail_serves: tuple[int, ...] = (),
        preempt_serves: tuple[int, ...] = (),
        die_serves: tuple[int, ...] = (),
        return_serves: tuple[int, ...] = (),
        flaky_probes: dict[int, float] | None = None,
        slow_probes: dict[int, float] | None = None,
        stall_harvests: dict[int, float] | None = None,
        fail_harvests: tuple[int, ...] = (),
        corrupt_saves: dict[int, str] | None = None,
        corrupt_mode: str = "truncate",
        seed: int = 0,
    ) -> None:
        if corrupt_mode not in ("truncate", "flipbyte"):
            raise ValueError(f"corrupt_mode must be truncate|flipbyte, got {corrupt_mode!r}")
        for kind in (corrupt_saves or {}).values():
            if kind not in _ARTIFACTS:
                raise ValueError(
                    f"corrupt-save artifact kind must be one of "
                    f"{sorted(_ARTIFACTS)}, got {kind!r}"
                )
        for idx, p in (flaky_probes or {}).items():
            if not 0.0 <= p <= 1.0:
                raise ValueError(
                    f"flaky@{idx}: probability must be in [0, 1], got {p}"
                )
        for idx, ms in (slow_probes or {}).items():
            if ms <= 0:
                raise ValueError(
                    f"slow@{idx}: delay must be > 0 ms, got {ms}"
                )
        self.nan_serves = tuple(nan_serves)
        self.inf_serves = tuple(inf_serves)
        self.stall_serves = dict(stall_serves or {})
        self.fail_serves = tuple(fail_serves)
        self.preempt_serves = tuple(preempt_serves)
        self.die_serves = tuple(die_serves)
        self.return_serves = tuple(return_serves)
        self.flaky_probes = dict(flaky_probes or {})
        self.slow_probes = dict(slow_probes or {})
        self.stall_harvests = dict(stall_harvests or {})
        self.fail_harvests = tuple(fail_harvests)
        self.corrupt_saves = dict(corrupt_saves or {})
        self.corrupt_mode = corrupt_mode
        self.seed = seed
        # fire-once bookkeeping; hooks run on the train loop, the prefetch
        # worker, the watchdog executor, and the checkpoint writer thread
        self._lock = threading.Lock()
        self._fired: set[tuple[str, int]] = set()
        self._harvest_count = 0

    # ------------------------------------------------------------------
    @classmethod
    def parse(cls, spec: str | None) -> "Chaos | None":
        """Spec string → Chaos; empty/None → None (chaos fully disabled)."""
        if not spec or not spec.strip():
            return None
        kw: dict[str, Any] = {
            "nan_serves": [], "inf_serves": [], "stall_serves": {},
            "fail_serves": [], "preempt_serves": [], "die_serves": [],
            "return_serves": [], "flaky_probes": {}, "slow_probes": {},
            "stall_harvests": {}, "fail_harvests": [],
            "corrupt_saves": {},
        }
        for raw in spec.split(","):
            tok = raw.strip()
            if not tok:
                continue
            if tok.startswith("mode="):
                kw["corrupt_mode"] = tok[len("mode="):]
                continue
            if tok.startswith("seed="):
                kw["seed"] = int(tok[len("seed="):])
                continue
            if "@" not in tok:
                raise ValueError(f"bad chaos token {tok!r} (expected kind@index)")
            kind, _, arg = tok.partition("@")
            idx_s, _, extra = arg.partition(":")
            idx = int(idx_s)
            if kind == "nan":
                kw["nan_serves"].append(idx)
            elif kind == "inf":
                kw["inf_serves"].append(idx)
            elif kind == "stall":
                kw["stall_serves"][idx] = float(extra) if extra else _DEFAULT_STALL_S
            elif kind == "fail":
                kw["fail_serves"].append(idx)
            elif kind == "preempt":
                kw["preempt_serves"].append(idx)
            elif kind == "die":
                kw["die_serves"].append(idx)
            elif kind == "return":
                kw["return_serves"].append(idx)
            elif kind == "flaky":
                kw["flaky_probes"][idx] = float(extra) if extra else 0.5
            elif kind == "slow":
                kw["slow_probes"][idx] = float(extra) if extra else 1000.0
            elif kind == "stall-harvest":
                kw["stall_harvests"][idx] = float(extra) if extra else _DEFAULT_STALL_S
            elif kind == "fail-harvest":
                kw["fail_harvests"].append(idx)
            elif kind == "corrupt-save":
                kw["corrupt_saves"][idx] = extra or "weights"
            else:
                raise ValueError(f"unknown chaos fault kind {kind!r} in {tok!r}")
        kw["nan_serves"] = tuple(kw["nan_serves"])
        kw["inf_serves"] = tuple(kw["inf_serves"])
        kw["fail_serves"] = tuple(kw["fail_serves"])
        kw["preempt_serves"] = tuple(kw["preempt_serves"])
        kw["die_serves"] = tuple(kw["die_serves"])
        kw["return_serves"] = tuple(kw["return_serves"])
        kw["fail_harvests"] = tuple(kw["fail_harvests"])
        return cls(**kw)

    def render(self) -> str:
        """The grammar's inverse: a canonical spec string such that
        ``Chaos.parse(c.render())`` plans the identical fault schedule
        (round-trip tested in tests/test_torch_chaos.py)."""
        toks: list[str] = []
        for label, idxs in (("nan", self.nan_serves), ("inf", self.inf_serves),
                            ("fail", self.fail_serves),
                            ("preempt", self.preempt_serves),
                            ("die", self.die_serves),
                            ("return", self.return_serves),
                            ("fail-harvest", self.fail_harvests)):
            toks.extend(f"{label}@{i}" for i in sorted(idxs))
        for label, table in (("stall", self.stall_serves),
                             ("flaky", self.flaky_probes),
                             ("slow", self.slow_probes),
                             ("stall-harvest", self.stall_harvests)):
            toks.extend(f"{label}@{i}:{v:g}" for i, v in sorted(table.items()))
        toks.extend(f"corrupt-save@{v}:{kind}"
                    for v, kind in sorted(self.corrupt_saves.items()))
        if self.corrupt_mode != "truncate":
            toks.append(f"mode={self.corrupt_mode}")
        if self.seed:
            toks.append(f"seed={self.seed}")
        return ",".join(toks)

    @classmethod
    def from_cfg_env(cls, cfg) -> "Chaos | None":
        """The production wiring point: ``cfg.chaos``, else the
        ``CROSSCODER_CHAOS`` env var, else None."""
        import os

        return cls.parse(getattr(cfg, "chaos", "") or os.environ.get("CROSSCODER_CHAOS", ""))

    # ------------------------------------------------------------------
    def _fire(self, kind: str, idx: int) -> bool:
        """True exactly once per (kind, idx); thread-safe."""
        key = (kind, idx)
        with self._lock:
            if key in self._fired:
                return False
            self._fired.add(key)
            return True

    # --- serve-path hooks (trainer batch production) -------------------
    def on_serve(self, serve: int) -> None:
        """Stall or raise at the start of serve ``serve`` (before the
        buffer's state is touched, so a retry after the fault is safe)."""
        if serve in self.stall_serves and self._fire("stall_serve", serve):
            time.sleep(self.stall_serves[serve])
        if serve in self.fail_serves and self._fire("fail_serve", serve):
            raise ChaosFault(f"chaos: injected failure at serve {serve}")
        if serve in self.preempt_serves and self._fire("preempt", serve):
            # the preemption notice: SIGTERM to self — the trainer's
            # handler turns it into a coordinated stop-and-save
            import os
            import signal

            print(f"[crosscoder_tpu_torch] chaos: preempting self (SIGTERM) at "
                  f"serve {serve}", flush=True, file=sys.stderr)
            os.kill(os.getpid(), signal.SIGTERM)
        if serve in self.die_serves and self._fire("die", serve):
            # abrupt host loss: no cleanup, no notification — the process
            # vanishes mid-run exactly like a preempted/failed host whose
            # notice never arrived (elastic membership's fault model)
            import os

            print(f"[crosscoder_tpu_torch] chaos: dying (os._exit) at serve "
                  f"{serve}", flush=True, file=sys.stderr)
            sys.stderr.flush()
            os._exit(43)

    def take_return(self, serve: int) -> bool:
        """True exactly once when a ``return@serve`` grant is planned: the
        fleet hands capacity back at this serve, and the caller (the
        trainer, on the surviving coordinator) opens the rejoin window on
        the elastic controller's rendezvous board."""
        return serve in self.return_serves and self._fire("return", serve)

    # --- probe-path hooks (elastic liveness barriers) -------------------
    def on_probe(self, probe: int) -> str | float | None:
        """Behavior of liveness-probe index ``probe`` on THIS host:

        - ``"skip"`` — flaky: miss the probe barrier entirely (the peers
          time out and count a suspect; the controller sits out the same
          grace window so the probe phases stay aligned);
        - a float — slow: join the barrier that many SECONDS late;
        - ``None`` — healthy.

        Slow faults are fire-once events; flaky is a persistent property
        from its start index, with a per-probe seeded coin so the miss
        pattern is deterministic and precomputable by drills."""
        if probe in self.slow_probes and self._fire("slow_probe", probe):
            return self.slow_probes[probe] / 1000.0
        starts = [s for s in self.flaky_probes if s <= probe]
        if starts:
            p = self.flaky_probes[max(starts)]
            if p > 0 and np.random.default_rng(
                    (self.seed, _FLAKY_STREAM, probe)).random() < p:
                return "skip"
        return None

    def poison_batch(self, batch: Any, serve: int, inplace: bool = False) -> Any:
        """Row 0 of serve ``serve``'s batch set to NaN/Inf, in a copy of
        ``batch`` (a numpy array or a tensor, on whatever device it lies;
        the copy runs on the current stream), or in ``batch`` itself with
        ``inplace=True``, for a batch the caller owns (a staging tensor it
        served into). A store's rows are never written: a device store
        may serve a view of them, and a poisoned row would poison every
        later replay."""
        bad = None
        if serve in self.nan_serves and self._fire("nan", serve):
            bad = float("nan")
        elif serve in self.inf_serves and self._fire("inf", serve):
            bad = float("inf")
        if bad is None:
            return batch
        if not inplace:
            batch = np.array(batch, copy=True) if isinstance(batch, np.ndarray) else batch.clone()
        batch[0] = bad
        return batch

    # --- harvest-path hook (buffer chunk dispatch) ----------------------
    def on_harvest(self) -> None:
        """Stall or raise by harvest-chunk index (internal monotone count)."""
        with self._lock:
            n = self._harvest_count
            self._harvest_count += 1
        if n in self.stall_harvests and self._fire("stall_harvest", n):
            time.sleep(self.stall_harvests[n])
        if n in self.fail_harvests and self._fire("fail_harvest", n):
            raise ChaosFault(f"chaos: injected failure at harvest chunk {n}")

    # --- checkpoint-path hook (writer, after meta lands) ----------------
    def corrupt_save(self, save_dir: str | Path, v: int) -> None:
        """Corrupt one artifact of save ``v`` on disk, per the plan."""
        kind = self.corrupt_saves.get(v)
        if kind is None or not self._fire("corrupt", v):
            return
        path = Path(save_dir) / _ARTIFACTS[kind].format(v=v)
        data = path.read_bytes()
        if self.corrupt_mode == "truncate":
            path.write_bytes(data[: len(data) // 2])
        else:  # flipbyte
            off = int(np.random.default_rng(self.seed + v).integers(0, max(len(data), 1)))
            flipped = bytearray(data)
            flipped[off] ^= 0xFF
            path.write_bytes(bytes(flipped))
        print(f"[crosscoder_tpu_torch] chaos: corrupted ({self.corrupt_mode}) "
              f"{path.name} of save {v}", flush=True, file=sys.stderr)
