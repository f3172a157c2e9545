"""Serve-replica membership, ported from :mod:`crosscoder_tpu.serve.replica`:
a preempted replica drains its queue to its peers.

Replicas share a filesystem board (shared storage on a fleet, any
directory in tests), written by atomic tmp + ``os.replace``:

- each replica ``announce``s itself with a rising heartbeat ``seq``;
- a preempted replica's last act is ``post_drain``: it spools its queued
  requests (:meth:`InferenceEngine.drain_queue`) to a drain record;
- a peer ``claim_drains``: the claim is an ``os.replace`` rename, so one
  peer wins a record even when several poll at once, and it re-submits
  the spooled requests into its own engine (``serve/adopted_total``).

Micro-batches already dispatched to the device are not drained: they
complete or die with the host. Host code only: no kernel of its own.
"""

from __future__ import annotations

import contextlib
import json
import os
from pathlib import Path

import numpy as np

from crosscoder_tpu_torch.obs import trace

__all__ = ["ReplicaBoard", "ServeReplica"]


class ReplicaBoard:
    """Filesystem membership board for serve replicas."""

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

    # -- membership ------------------------------------------------------

    def announce(self, replica_id: str, seq: int, *, queued: int = 0) -> None:
        self._write_json(self.root / f"replica_{replica_id}.json",
                         {"id": replica_id, "seq": int(seq), "queued": int(queued)})

    def retract(self, replica_id: str) -> None:
        with contextlib.suppress(OSError):
            (self.root / f"replica_{replica_id}.json").unlink()

    def peers(self, exclude: str | None = None) -> list[dict]:
        return [rec for p in sorted(self.root.glob("replica_*.json"))
                if (rec := self._read_json(p)) is not None and rec.get("id") != exclude]

    # -- drain hand-off --------------------------------------------------

    def post_drain(self, replica_id: str, requests: list[tuple[int, np.ndarray]]) -> int:
        """Spool a dying replica's queued requests (token arrays as plain
        lists); returns the count spooled."""
        self._write_json(self.root / f"drain_{replica_id}.json", {
            "id": replica_id,
            "requests": [[int(rid), np.asarray(t).tolist()] for rid, t in requests],
        })
        return len(requests)

    def claim_drains(self, claimant_id: str) -> list[dict]:
        """Claim every unclaimed drain record but the claimant's own: the
        rename is the lock, so of two racing claimants one wins each
        record (the loser's source path is gone)."""
        claimed = []
        for p in sorted(self.root.glob("drain_*.json")):
            if p.name.startswith(f"drain_{claimant_id}"):
                continue
            dst = p.with_name(f"claimed_{claimant_id}_{p.name}")
            try:
                os.replace(p, dst)
            except OSError:
                continue    # a peer won the race
            rec = self._read_json(dst)
            if rec is not None:
                claimed.append(rec)
        return claimed


class ServeReplica:
    """One engine on a :class:`ReplicaBoard`. :meth:`heartbeat`, at the
    replica's poll cadence, refreshes its announce and adopts any peer's
    drain spool through the engine's own admission (an overloaded
    survivor sheds adopted requests as it sheds new ones);
    :meth:`preempt` is the SIGTERM handler's body: drain, spool, retract."""

    def __init__(self, replica_id: str, engine, board: ReplicaBoard) -> None:
        self.replica_id = replica_id
        self.engine = engine
        self.board = board
        self._seq = 0

    def heartbeat(self) -> int:
        """One membership beat; returns the number of adopted requests."""
        self._seq += 1
        self.board.announce(self.replica_id, self._seq, queued=self.engine.n_queued)
        adopted = 0
        for rec in self.board.claim_drains(self.replica_id):
            for _rid, tokens in rec.get("requests", []):
                try:
                    self.engine.submit(np.asarray(tokens, np.int32))
                except Exception:   # noqa: BLE001 — shed: lost here, never acknowledged
                    continue
                adopted += 1
                self.engine.registry.count("serve/adopted_total")
        if adopted:
            trace.instant("drain_adopt", replica=self.replica_id, requests=adopted)
        return adopted

    def preempt(self) -> int:
        """Spool the queue for peers and leave the board; returns the
        number of requests spooled."""
        drained = self.engine.drain_queue()
        n = self.board.post_drain(self.replica_id, drained) if drained else 0
        self.board.retract(self.replica_id)
        trace.instant("drain_post", replica=self.replica_id, requests=n)
        return n
