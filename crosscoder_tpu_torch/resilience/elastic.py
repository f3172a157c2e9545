"""Elastic membership: survive the loss of a host mid-run (``cfg.elastic``),
ported from :mod:`crosscoder_tpu.resilience.elastic` (the loss side).

- **Liveness**: a bounded membership barrier on the store rank 0 hosts
  (:func:`crosscoder_tpu_torch.parallel.multihost.probe_liveness`) at the
  trainer's ``stop_poll_every`` cadence. A peer that dies mid-collective
  surfaces as an exception out of the step (its sockets close);
  :meth:`ElasticController.confirm_peer_loss` tells that apart from an
  ordinary software error with one more bounded barrier.
- **Hysteresis**: a failed probe is a suspicion until
  ``cfg.elastic_suspect_probes`` fail in a row (``resilience/elastic_suspects``);
  any success resets the count. Flaky and slow hosts (chaos ``flaky@``,
  ``slow@``) cost grace windows, not remeshes. A torn collective is never a
  flake.
- **Membership epochs** are monotone: every survivor re-mesh bumps the
  epoch (:func:`~crosscoder_tpu_torch.parallel.multihost.shrink_to_local`),
  and every liveness key embeds it.
- **Re-meshing**: the survivors (the coordinator host's ranks) join a new
  group and rebuild the ``data`` × ``model`` grid over it, the TP width
  kept and the data axis taking the rest. The trainer drops its state and
  restores the newest verified save, as the JAX trainer does: a torn
  all-reduce leaves gradients half summed, so live state is never salvaged.

Only the coordinator host's ranks survive: the store dies with rank 0's
host, as the JAX coordination service dies with process 0's.

Off (``cfg.elastic="off"``, the default) no controller exists and the
train loop carries only is-None checks. Scale-up (``cfg.elastic_grow``:
the rendezvous board, ``grow_to``, the fleet policy) is not ported yet.
"""

from __future__ import annotations

import sys
import time

from crosscoder_tpu_torch.parallel import mesh as mesh_lib
from crosscoder_tpu_torch.parallel import multihost


class PeerLoss(RuntimeError):
    """Raised into the train loop when membership confirms a dead peer."""


def survivor_shape(n: int, model_axis_size: int) -> tuple[int, int]:
    """``(data, model)`` of the grid over ``n`` surviving ranks: the TP
    width kept, the data axis taking the rest; :class:`PeerLoss` when
    ``n`` does not divide by it."""
    model = max(1, int(model_axis_size))
    if n % model:
        raise PeerLoss(f"survivor world has {n} devices, not divisible by "
                       f"model_axis_size={model}; cannot re-mesh")
    return n // model, model


class ElasticController:
    """Liveness probing and the survivor re-mesh for one training run.

    The trainer owns quiescing its in-flight work and rebuilding what the
    grid shaped; this controller owns the membership protocol: when to
    probe, what a failed probe means, and how the survivor world is built.
    """

    def __init__(self, cfg, counters=None, chaos=None) -> None:
        self.cfg = cfg
        self.counters = counters
        self._chaos = chaos     # probe-path fault injection (flaky/slow)
        self._confirm_seq = 0   # exception-time probes, SPMD-consistent
        self._probe_count = 0   # monotone probe index (chaos keys)
        self._suspect = 0       # consecutive failed probes (hysteresis)
        bound = multihost.collective_timeout_s()
        if self.active() and bound < cfg.elastic_grace_s:
            raise ValueError(
                f"the elastic world's collective timeout ({bound} s) is below "
                f"elastic_grace_s ({cfg.elastic_grace_s} s): a torn collective must not "
                f"give up before a probe could confirm the loss")

    def _bump(self, key: str, n: int = 1) -> None:
        if self.counters is not None:
            self.counters.bump(key, n)

    # -- liveness --------------------------------------------------------

    def active(self) -> bool:
        m = multihost.membership()
        return m is not None and m.num_processes > 1

    def epoch(self) -> int:
        m = multihost.membership()
        return 0 if m is None else m.epoch

    def should_probe(self, step: int) -> bool:
        """Probe at the trainer's stop-poll cadence: the same steps on every
        rank, so the barrier keys are SPMD-consistent."""
        return self.active() and step % int(self.cfg.stop_poll_every) == 0

    def probe(self, step: int) -> bool:
        """True when every peer is alive; False DECLARES peer loss.

        One failed barrier is a suspicion; ``cfg.elastic_suspect_probes``
        misses in a row declare loss, and a success resets the count (and
        clears the flag a timed-out barrier latched). Chaos: ``flaky@S:p``
        makes THIS host skip the barrier and sit out the grace window its
        peers spend timing out, so the probe phases stay aligned;
        ``slow@S:ms`` joins late. A successful probe slower than
        ``cfg.elastic_heartbeat_s`` counts in ``elastic_slow_probes``."""
        self._bump("elastic_probes")
        behavior = None
        if self._chaos is not None:
            behavior = self._chaos.on_probe(self._probe_count)
        self._probe_count += 1
        if behavior == "skip":
            self._bump("elastic_skipped_probes")
            time.sleep(self.cfg.elastic_grace_s)
            return True
        if isinstance(behavior, float):
            time.sleep(behavior)
        t0 = time.perf_counter()
        ok = multihost.probe_liveness(f"p{step}", timeout_s=self.cfg.elastic_grace_s)
        if ok:
            if time.perf_counter() - t0 > self.cfg.elastic_heartbeat_s:
                self._bump("elastic_slow_probes")
            self._suspect = 0
            return True
        self._suspect += 1
        self._bump("elastic_suspects")
        if self._suspect >= int(self.cfg.elastic_suspect_probes):
            return False
        print(f"[crosscoder_tpu_torch] elastic: probe p{step} missed ({self._suspect}/"
              f"{self.cfg.elastic_suspect_probes} before loss is declared)", flush=True,
              file=sys.stderr)
        multihost.clear_peer_loss()
        return True

    def confirm_peer_loss(self, exc: BaseException) -> bool:
        """An exception escaped the step or the serve: a dying peer (a
        collective torn mid-flight) or an ordinary bug? The latched flag
        answers at once; otherwise one bounded barrier does. Every healthy
        rank hit the same failure point and runs the same confirmation, so
        a software error confirms healthy everywhere and re-raises."""
        if not self.active():
            return False
        if multihost.peer_loss_flagged():
            return True
        self._confirm_seq += 1
        print(f"[crosscoder_tpu_torch] elastic: confirming membership after "
              f"{type(exc).__name__}", flush=True, file=sys.stderr)
        return not multihost.probe_liveness(f"x{self._confirm_seq}",
                                            timeout_s=self.cfg.elastic_grace_s)

    # -- survivor re-mesh --------------------------------------------------

    def shrink(self) -> mesh_lib.Mesh:
        """Re-mesh over the survivor set (the coordinator host's ranks):
        returns the new grid. Callers must treat every value a collective of
        the old world touched as unknown and restore from a save."""
        m = multihost.membership()
        if m is None:
            raise PeerLoss("peer lost but no elastic membership to shrink")
        if not multihost.on_coordinator_host():
            # the store died with (or lives on) another host: this rank
            # cannot join the survivor world
            raise PeerLoss("peer loss detected on a non-coordinator host: only the "
                           "coordinator host's ranks can re-mesh; exiting")
        t0 = time.perf_counter()
        new_m = multihost.shrink_to_local()
        mesh = self.survivor_mesh()
        self._bump("remeshes")
        print(f"[crosscoder_tpu_torch] elastic: re-meshed to epoch {new_m.epoch} "
              f"({new_m.num_processes} ranks, {1000 * (time.perf_counter() - t0):.0f} ms "
              f"regroup)", flush=True, file=sys.stderr)
        return mesh

    def survivor_mesh(self) -> mesh_lib.Mesh:
        """The ``data`` × ``model`` grid over the surviving world
        (:func:`survivor_shape`)."""
        return mesh_lib.make_mesh(*survivor_shape(multihost.world_size(),
                                                  self.cfg.model_axis_size))
