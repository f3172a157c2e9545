"""The telemetry plane (``cfg.obs``), ported from :mod:`crosscoder_tpu.obs`.

:class:`Observability` owns a run's telemetry and its lifetime:

- a :class:`~crosscoder_tpu_torch.obs.trace.SpanTracer` installed as the
  process-global tracer, so the span sites of the buffer, the
  checkpointer, the watchdog, the serve engine and the fleet record
  without new parameters; each span feeds ``perf/<name>_ms`` (EMA) and
  ``perf/<name>_spans`` into the registry;
- a :class:`~crosscoder_tpu_torch.obs.registry.MetricsRegistry` whose
  snapshot the Trainer merges into each log line (``perf/*``, ``comm/*``),
  as it merges the ``resilience/*`` counters;
- the refill-bubble accounting (:meth:`add_blocked_ns`,
  :meth:`take_blocked_s`: the loop's time blocked on the next batch);
- the comm gauges of a step (:meth:`account_comm`):
  ``comm/predicted_wire_bytes``, ``comm/collective_output_bytes`` and
  ``comm/collectives_per_step``, from the collectives that step counted
  through :mod:`crosscoder_tpu_torch.parallel.collectives`, put through
  :func:`crosscoder_tpu_torch.parallel.comm_model.wire_bytes`. The JAX
  package reads them out of each compiled step variant's HLO; the Trainer
  here accounts each variant's first step.

The JAX plane's ``observe_step`` and ``on_compile`` have no counterpart:
the port compiles no step, so the ``perf/compile*`` keys (``perf/compiles``,
``perf/compile_s_*``, ``perf/compile_flops``, the ``compile`` span) are
absent from its logs.

Off by default: with ``cfg.obs == "off"`` the Trainer builds none of this,
every span site hits the shared null span, and a step makes the same
launches and host reads it makes without the plane (tests/test_torch_obs.py).
"""

from __future__ import annotations

import os
from typing import Any

from crosscoder_tpu_torch.obs import trace
from crosscoder_tpu_torch.obs.registry import MetricsRegistry
from crosscoder_tpu_torch.obs.trace import NullTracer, SpanTracer


class Observability:
    """One run's telemetry. The trace goes to ``cfg.obs_dir`` (default
    ``<checkpoint_dir>/obs``): ``trace.json`` on rank 0, ``trace.p{r}.json``
    on rank r of a joined process group. ``mesh``: the rank grid the
    trainer runs on (the comm gauges' width)."""

    def __init__(self, cfg: Any, mesh: Any | None = None) -> None:
        from crosscoder_tpu_torch.parallel import multihost

        self.cfg = cfg
        self.out_dir = cfg.obs_dir or os.path.join(cfg.checkpoint_dir, "obs")
        self.registry = MetricsRegistry()
        idx = multihost.rank()
        name = "trace.json" if idx == 0 else f"trace.p{idx}.json"
        self.tracer = SpanTracer(os.path.join(self.out_dir, name), registry=self.registry)
        self._prev_tracer = trace.set_tracer(self.tracer)
        self.mesh = mesh
        # nanoseconds the loop spent blocked on the next batch since the
        # last log point: the numerator of perf/refill_bubble_frac
        self._blocked_ns = 0
        self._closed = False

    # -- refill-bubble accounting (the trainer's hot path) -------------------
    def add_blocked_ns(self, ns: int) -> None:
        self._blocked_ns += ns

    def take_blocked_s(self) -> float:
        """Seconds blocked on the next batch since the last call."""
        ns, self._blocked_ns = self._blocked_ns, 0
        return ns / 1e9

    # -- comm gauges ----------------------------------------------------------
    @staticmethod
    def comm_mark() -> tuple[dict[str, int], dict[str, int]]:
        """The collective counters as they stand (bytes, calls that moved
        bytes): the start of a step :meth:`account_comm` reads."""
        from crosscoder_tpu_torch.parallel import collectives as coll

        return dict(coll.bytes), dict(coll.wire_calls)

    def account_comm(self, mark: tuple[dict[str, int], dict[str, int]]) -> None:
        """The comm gauges of the collectives counted since ``mark``: one
        step's, on the mesh the trainer runs on (all 0 off a grid)."""
        from crosscoder_tpu_torch.parallel import collectives as coll
        from crosscoder_tpu_torch.parallel import comm_model

        b0, c0 = mark
        by_op = {jax_op: int(coll.bytes[op]) - b0.get(op, 0)
                 for op, jax_op in comm_model._OPS.items()}
        by_op["count"] = int(sum(coll.wire_calls.values())) - sum(c0.values())
        mesh = self.mesh
        n_dev = mesh.data_size * mesh.model_size if mesh is not None else 1
        model_axis = mesh.model_size if mesh is not None else 1
        profile = comm_model.CommProfile("train_step", n_dev, model_axis, by_op)
        r = self.registry
        r.gauge("comm/predicted_wire_bytes", comm_model.wire_bytes(profile))
        r.gauge("comm/collective_output_bytes", float(profile.total_bytes))
        r.gauge("comm/collectives_per_step", float(by_op["count"]))

    # -- lifetime -------------------------------------------------------------
    def flush(self) -> None:
        self.tracer.flush()

    def close(self) -> None:
        """Write the trace and give the process-global tracer back.
        Idempotent."""
        if self._closed:
            return
        self._closed = True
        trace.set_tracer(self._prev_tracer)
        self.tracer.close()


__all__ = ["Observability", "MetricsRegistry", "NullTracer", "SpanTracer", "trace"]
