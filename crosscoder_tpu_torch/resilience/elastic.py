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

**Scale-up** (``cfg.elastic_grow``), as JAX's:

- **Rejoin rendezvous** on a filesystem board
  (``<checkpoint_dir>/elastic_board``, :class:`RendezvousBoard`): a
  returned host posts sequence-stamped announces; the shrunk survivors poll
  at the probe cadence and admit a candidate once they have seen its
  announce advance ``cfg.elastic_grow_debounce`` times, at least
  ``cfg.elastic_dwell_steps`` steps after the last re-mesh.
- **Admission is a boundary save**: the survivors quiesce, save (state and
  stream position), post an admit record naming that save, the store's
  address and each joiner's rank, and re-form the wider world on the same
  store (:func:`~crosscoder_tpu_torch.parallel.multihost.grow_to`; the
  store lives on with rank 0, where JAX's admit names a fresh coordinator
  port). Every member restores the same save, so the grown world's steps
  are bitwise a clean start's at the wide shape from it. A joiner that
  vanished before the rendezvous costs the survivors the arrival barrier's
  bound; they burn the failed epoch and go on narrow.
- **The grid** comes from :class:`~crosscoder_tpu_torch.resilience.fleet.FleetPolicy`.

Survivors of more than one rank (the coordinator host's ranks; JAX's
survivor is one process, ROADMAP C15): rank 0 alone reads the board and
shares its decision, and the admit record, under a key of the epoch and
the occasion on the store, so every survivor answers :meth:`ElasticController.grow_ready`
alike at the same step. A returned host comes back whole: ONE announce
speaks for it (its local rank 0, ``devices`` = its ranks, which must be
the world's ``local_world_size``), the record's ``assignments`` give that
host's first rank, and its local rank ``l`` takes first + ``l``, so ranks
stay host-major and a later shrink keeps the coordinator host's ranks
again. At one rank a host this is JAX's protocol exactly.

Off (``cfg.elastic="off"``, the default) no controller exists and the
train loop carries only is-None checks; with ``cfg.elastic_grow="off"`` no
board and no policy exist. With a pinned tuned artifact (``cfg.tuned``)
every re-mesh checks it against the new world
(:func:`crosscoder_tpu_torch.tune.artifact.on_remesh`), counted under
``resilience/retune_*``.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from pathlib import Path

from crosscoder_tpu_torch.parallel import mesh as mesh_lib
from crosscoder_tpu_torch.parallel import multihost


class PeerLoss(RuntimeError):
    """Raised into the train loop when membership confirms a dead peer."""


class GrowAborted(RuntimeError):
    """A grow admission that could not complete (candidates vanished
    between debounce and rendezvous); the survivor falls back to its
    narrow world and keeps training."""


class RendezvousBoard:
    """Filesystem rendezvous for returned hosts (``cfg.elastic_grow``), JAX's.

    A directory under the run's ``checkpoint_dir`` (shared storage on a
    real fleet) where candidates post announces and the surviving
    coordinator posts the admit record. Every write is atomic (a temporary
    file, then a rename), so a reader never sees torn JSON, also when the
    trainer's prefetch worker posts the grant.

    Freshness is counted by SEQUENCE, not by clock: a candidate rewrites
    its announce with a rising ``seq`` every beat, and the coordinator
    counts an advance since its previous poll. No clocks are compared
    across hosts, and a crashed candidate goes stale within one poll.
    """

    def __init__(self, root: str | os.PathLike) -> None:
        self.root = Path(root)

    def _write_json(self, path: Path, payload: dict) -> None:
        self.root.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".tmp-{os.getpid()}")
        tmp.write_text(json.dumps(payload))
        os.replace(tmp, path)

    @staticmethod
    def _read_json(path: Path) -> dict | None:
        try:
            return json.loads(path.read_text())
        except (OSError, ValueError):
            return None     # mid-replace or gone: absent

    # -- the capacity grant (the return@S chaos token lands here) ----------

    def post_grant(self, payload: dict) -> None:
        """The fleet granted capacity back: open the rejoin window. The
        drill's parked rejoiner waits on this before announcing; a real
        returned host announces directly and never reads it."""
        self._write_json(self.root / "grant.json", payload)

    def read_grant(self) -> dict | None:
        return self._read_json(self.root / "grant.json")

    # -- the candidate's side ------------------------------------------------

    def announce(self, candidate_id: str, devices: int, seq: int) -> None:
        self._write_json(self.root / f"join_{candidate_id}.json",
                         {"id": candidate_id, "devices": int(devices), "seq": int(seq)})

    def retract(self, candidate_id: str) -> None:
        with contextlib.suppress(OSError):
            (self.root / f"join_{candidate_id}.json").unlink()

    def read_admit(self) -> dict | None:
        """The newest admit record (by epoch), or None."""
        best = None
        for p in self.root.glob("admit_*.json"):
            rec = self._read_json(p)
            if rec and (best is None or rec["epoch"] > best["epoch"]):
                best = rec
        return best

    def announce_until_admitted(self, candidate_id: str, devices: int, timeout_s: float,
                                beat_s: float = 0.25) -> dict:
        """The candidate's courtship: post freshness beats until an admit
        record naming this candidate appears, and return it. The announce is
        retracted either way (an admission consumed it; after a
        :class:`TimeoutError` the candidate gives up cleanly)."""
        deadline = time.monotonic() + timeout_s
        seq = 0
        try:
            while time.monotonic() < deadline:
                self.announce(candidate_id, devices, seq)
                seq += 1
                admit = self.read_admit()
                if admit and candidate_id in admit.get("assignments", {}):
                    return admit
                time.sleep(beat_s)
        finally:
            self.retract(candidate_id)
        raise TimeoutError(f"rejoin candidate {candidate_id} was not admitted within "
                           f"{timeout_s:.0f}s")

    # -- the coordinator's side ----------------------------------------------

    def poll_announces(self) -> list[dict]:
        return [rec for p in sorted(self.root.glob("join_*.json"))
                if (rec := self._read_json(p)) is not None]

    def post_admit(self, record: dict) -> None:
        self._write_json(self.root / f"admit_{record['epoch']}.json", record)

    def clear_admit(self, epoch: int) -> None:
        with contextlib.suppress(OSError):
            (self.root / f"admit_{epoch}.json").unlink()


def join_grown_world(admit: dict, candidate_id: str, *, device=None, local_rank: int = 0,
                     barrier_timeout_s: float = 30.0) -> mesh_lib.Mesh:
    """The joiner's rendezvous: enter the world an admit record describes,
    at the rank the record gives this host's local rank ``local_rank``
    (its first rank plus ``local_rank``), on ``device`` (the card unless
    named). Returns the grown world's grid, built from the record's shape
    so every member lays the same axes over the same ranks. The caller then
    builds its trainer on it and restores the record's boundary save."""
    pid = int(admit["assignments"][candidate_id]) + int(local_rank)
    m = multihost.grow_to(admit["coordinator_address"], int(admit["num_processes"]), pid,
                          int(admit["epoch"]), device=device, backend=admit.get("backend"),
                          timeout_s=float(admit["timeout_s"]),
                          local_world_size=int(admit["local_world_size"]))
    if not multihost.probe_liveness(f"g{m.epoch}", timeout_s=barrier_timeout_s):
        raise GrowAborted(f"admission barrier of epoch {m.epoch} failed on joiner {pid}")
    return mesh_lib.make_mesh(int(admit["n_data"]), int(admit["n_model"]))


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
        self._last_remesh_step: int | None = None
        # -- scale-up (cfg.elastic_grow; None when off) --------------------
        self._board = None
        self._policy = None
        self._stable_candidates: list[dict] = []
        # id -> (seq, observed-advance streak, local time of the last advance)
        self._cand_freshness: dict[str, tuple[int, int, float]] = {}
        self._grow_polls = 0        # board polls reached, the same on every survivor
        self.last_admit: dict | None = None   # the admit record of the latest grow
        if cfg.elastic_grow == "on":
            from crosscoder_tpu_torch.resilience.fleet import FleetPolicy

            self._board = RendezvousBoard(Path(cfg.checkpoint_dir) / "elastic_board")
            self._policy = FleetPolicy(cfg)
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

    # -- scale-up (cfg.elastic_grow) ----------------------------------------

    def note_remesh(self, step: int) -> None:
        """Anchor the dwell clock: the trainer reports the step each shrink
        or grow resumed at, and :meth:`grow_ready` refuses another re-mesh
        within ``cfg.elastic_dwell_steps`` of it (flap damping). The
        courtship bookkeeping starts over.

        Also the tuner's re-mesh hook: with a pinned ``TUNED.json``
        (``cfg.tuned``) the new world (its size, as JAX's device count) is
        checked against the artifact: a per-topology sibling swaps its knobs
        in, a miss flags the pinned knobs stale; each outcome is counted
        (``resilience/retune_{off,current,cache_hit,stale,error}``), and an
        error never stops the re-mesh."""
        self._last_remesh_step = int(step)
        self._cand_freshness.clear()
        self._stable_candidates = []
        if getattr(self.cfg, "tuned", ""):
            from crosscoder_tpu_torch.tune import artifact as tune_artifact

            try:
                self.cfg, status = tune_artifact.on_remesh(self.cfg, multihost.world_size())
            except Exception as e:  # noqa: BLE001 — the re-mesh must survive
                print(f"[crosscoder_tpu_torch] elastic: tuned-artifact remesh check failed "
                      f"({type(e).__name__}: {e})"[:300], file=sys.stderr, flush=True)
                status = "error"
            self._bump(f"resilience/retune_{status}")

    def open_rejoin_window(self, serve: int) -> None:
        """The chaos ``return@S`` token lands here: the fleet grants capacity
        back at serve ``serve``, posting the grant the drill's parked
        rejoiner waits for. Inert (no board) unless ``cfg.elastic_grow="on"``."""
        if self._board is not None:
            self._board.post_grant({"serve": int(serve)})

    def _shrunk(self, m: multihost.Membership | None) -> bool:
        """True in a world of exactly the coordinator host's ranks (JAX's
        shrunk single-process world at one rank a host)."""
        return (m is not None and m.num_processes == multihost.local_world_size()
                and multihost.on_coordinator_host())

    def grow_ready(self, step: int) -> bool:
        """One poll of the rejoin board, at the stop-poll cadence.

        True when a debounced candidate set waits AND the dwell has passed:
        the trainer then quiesces, writes the boundary save and calls
        :meth:`grow`. Only a world of the coordinator host's ranks grows
        (the shrink narrows to them, the grow widens from there); any other
        world returns False without touching the board. On more than one
        survivor rank, rank 0 polls and shares its answer and the stable
        set on the store; the others wait for it up to ``elastic_grace_s``
        (the probe before this poll has just aligned them) and answer
        False, logged, if it does not come."""
        if self._board is None:
            return False
        m = multihost.membership()
        if not self._shrunk(m):
            return False
        if step % int(self.cfg.stop_poll_every) != 0:
            return False
        if (self._last_remesh_step is not None
                and step - self._last_remesh_step < int(self.cfg.elastic_dwell_steps)):
            return False
        self._grow_polls += 1
        mine = self._poll_candidates() if m.process_id == 0 else None
        if m.num_processes > 1:
            got = multihost.share_from_coordinator(
                f"grow_ready_{step}_{self._grow_polls}",
                None if mine is None else json.dumps(mine).encode(),
                self.cfg.elastic_grace_s)
            mine = [] if got is None else json.loads(got)
        self._stable_candidates = mine
        return bool(mine)

    def _poll_candidates(self) -> list[dict]:
        """Freshness-debounced polling: a candidate counts toward admission
        once the coordinator has OBSERVED its announce ``seq`` advance
        ``cfg.elastic_grow_debounce`` times (the first sighting counts as
        one), so the debounce means the same at any ratio of poll rate to
        beat rate. Staleness is judged on this host's own monotonic clock:
        a ``seq`` that has not advanced within one grace window means the
        candidate crashed mid-courtship, and its streak restarts. A vanished
        announce drops out. An announce whose ``devices`` is not the
        world's ranks a host is skipped (a host comes back whole)."""
        now = time.monotonic()
        fresh: dict[str, tuple[int, int, float]] = {}
        stable: list[dict] = []
        per_host = multihost.local_world_size()
        for rec in self._board.poll_announces():
            cid, seq = rec["id"], int(rec["seq"])
            last = self._cand_freshness.get(cid)
            if last is None:
                entry = (seq, 1, now)
            elif seq > last[0]:
                entry = (seq, last[1] + 1, now)
            elif now - last[2] > float(self.cfg.elastic_grace_s):
                entry = (seq, 0, last[2])    # gone stale: restart the courtship
            else:
                entry = last                 # between beats: the streak holds
            fresh[cid] = entry
            if entry[1] >= int(self.cfg.elastic_grow_debounce):
                if int(rec["devices"]) == per_host:
                    stable.append(rec)
                else:
                    print(f"[crosscoder_tpu_torch] elastic: candidate {cid} announces "
                          f"{rec['devices']} ranks, not a host's {per_host}; not admitted",
                          flush=True, file=sys.stderr)
        self._cand_freshness = fresh     # vanished candidates drop out
        return stable

    def grow(self, step: int, save_version: int, version_dir: str, save_step: int):
        """Admit the debounced candidates and re-form the wider world.

        The trainer has quiesced and written boundary save ``save_version``
        at ``save_step``; the admit record names it, and EVERY member
        restores exactly that save, so the grown world's steps are bitwise
        a clean start's at the wide shape from the same save (the save,
        stream position inside, is the broadcast). The record's fields are
        JAX's (``epoch``, ``coordinator_address``, ``num_processes``,
        ``assignments``, ``save``, ``step``, ``version_dir``, ``n_data``,
        ``n_model``) and the world's settings a joiner needs
        (``local_world_size``, ``timeout_s``, ``backend``). On more than
        one survivor rank, rank 0 builds and posts it and shares it on the
        store; :attr:`last_admit` holds it on every survivor.

        Returns ``(grid, admit_record)``. If the rendezvous fails (the
        candidates vanished between the debounce and the connection), the
        failed epoch is burned, the world re-forms narrow at the epoch after
        it, and ``(survivor grid, None)`` comes back: the run goes on narrow."""
        m = multihost.membership()
        if not self._shrunk(m):
            raise GrowAborted("grow without a shrunk world of the coordinator host's ranks "
                              "(JAX: a shrunk single-process world)")
        stable = self._stable_candidates
        if not stable:
            raise GrowAborted("grow without a debounced candidate set")
        per_host = multihost.local_world_size()
        epoch = multihost.next_epoch()
        admit = None
        if m.process_id == 0:
            choice = self._policy.choose(m.num_processes + sum(int(c["devices"])
                                                               for c in stable))
            admit = {
                "epoch": epoch,
                "coordinator_address": m.coordinator_address,
                "num_processes": per_host * (1 + len(stable)),
                "assignments": {c["id"]: per_host * h for h, c in enumerate(stable, start=1)},
                "save": int(save_version),
                "step": int(save_step),
                "version_dir": str(version_dir),
                "n_data": choice.n_data,
                "n_model": choice.n_model,
                "local_world_size": per_host,
                "timeout_s": multihost.collective_timeout_s(),
                "backend": multihost.backend_name(),
            }
        if m.num_processes > 1:
            got = multihost.share_from_coordinator(
                f"admit_{step}_{self._grow_polls}",
                None if admit is None else json.dumps(admit).encode(),
                max(30.0, 3 * self.cfg.elastic_grace_s))
            if got is None:
                raise GrowAborted(f"no admit record from rank 0 at step {step}")
            admit = json.loads(got)
            epoch = int(admit["epoch"])     # rank 0's, as every field of the record
        self.last_admit = admit
        if m.process_id == 0:
            print(f"[crosscoder_tpu_torch] elastic: admitting {len(stable)} candidate(s) at "
                  f"epoch {epoch} (grid data {admit['n_data']} x model {admit['n_model']}, "
                  f"boundary save {save_version})", flush=True, file=sys.stderr)
            self._board.post_admit(admit)
        t0 = time.perf_counter()
        try:
            multihost.grow_to(admit["coordinator_address"], admit["num_processes"],
                              m.process_id, epoch)
            if not multihost.probe_liveness(
                    f"g{epoch}", timeout_s=max(30.0, 3 * self.cfg.elastic_grace_s)):
                raise GrowAborted(f"admission barrier of epoch {epoch} failed")
        except Exception as e:  # noqa: BLE001 — any failed rendezvous falls back narrow
            self._bump("grow_aborts")
            if m.process_id == 0:
                self._board.clear_admit(epoch)
            print(f"[crosscoder_tpu_torch] elastic: grow to epoch {epoch} aborted "
                  f"({type(e).__name__}: {e}); continuing narrow"[:400], flush=True,
                  file=sys.stderr)
            multihost.shrink_to_local()     # burns the failed epoch
            return self.survivor_mesh(), None
        self._bump("remeshes")
        self._bump("grows")
        print(f"[crosscoder_tpu_torch] elastic: grew to epoch {epoch} "
              f"({admit['num_processes']} ranks, {1000 * (time.perf_counter() - t0):.0f} ms "
              f"world re-formation)", flush=True, file=sys.stderr)
        return mesh_lib.make_mesh(admit["n_data"], admit["n_model"]), admit
