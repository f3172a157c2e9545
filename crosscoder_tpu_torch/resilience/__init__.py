"""Fault injection and recovery for long training runs, ported from
:mod:`crosscoder_tpu.resilience` as far as one process uses it:

- :mod:`crosscoder_tpu_torch.resilience.chaos`: deterministic, seeded
  fault injection (NaN batches, corrupted saves, stalled or failing serves
  and harvests), on only through ``cfg.chaos`` or ``CROSSCODER_CHAOS``;
- :mod:`crosscoder_tpu_torch.resilience.watchdog`: timeout and backoff
  retry around the trainer's serve (``cfg.harvest_timeout_s``);
- the loss guard and rollback live in
  :class:`crosscoder_tpu_torch.train.trainer.Trainer` (``cfg.guard_loss``),
  the checksummed restore with fallback and ``keep_saves`` in
  :class:`crosscoder_tpu_torch.checkpoint.Checkpointer`.

- :mod:`crosscoder_tpu_torch.resilience.elastic`: elastic membership
  (liveness probes with hysteresis, the survivor re-mesh, the rejoin board
  and the grow), :mod:`crosscoder_tpu_torch.resilience.fleet`, the grid
  policy of a grow, and :mod:`crosscoder_tpu_torch.resilience.elastic_drill`,
  the preempt, autoscale and stability drills.

Recoveries count on the ``resilience/*`` channel
(:class:`crosscoder_tpu_torch.utils.logging.ResilienceCounters`).
"""

from crosscoder_tpu_torch.resilience.chaos import Chaos, ChaosFault
from crosscoder_tpu_torch.resilience.watchdog import Watchdog, WatchdogTimeout

__all__ = ["Chaos", "ChaosFault", "Watchdog", "WatchdogTimeout"]
