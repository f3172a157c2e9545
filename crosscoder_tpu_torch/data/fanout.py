"""Multi-consumer fan-out of one serve stream (the fleet's,
:mod:`crosscoder_tpu_torch.train.fleet`), ported from the JAX package's
replay buffer (``crosscoder_tpu/data/buffer.py`` ``attach_consumer`` …
``next_raw_for``) and synthetic source (``next_for``).

Each consumer holds a cursor into the stream: the position of the next
batch it is handed. The first consumer to reach a position pays the real
serve (one gather of the replay store, one synthetic batch); every other
consumer at that position is handed the same cached batch, so the stream
each consumer sees from its attach point on is bitwise what a solo run
would be served from the same position. Consumers drain each position
together (the fleet's lockstep rounds), so the cache holds one position;
a cursor neither there nor at the head raises :class:`RuntimeError`.

A class that mixes this in calls :meth:`FanOut._init_fanout` in its
constructor, defines :meth:`FanOut._stream_head` (the position its next
real serve yields) and adds :meth:`FanOut._consumer_state` to its
``state_dict`` and :meth:`FanOut._realign_consumers` to its
``load_state_dict``.
"""

from __future__ import annotations

from typing import Any, Callable


class FanOut:
    def _init_fanout(self) -> None:
        self._consumers: dict[str, int] = {}
        self._fanout_batch: Any = None
        self._fanout_seq = -1

    def _stream_head(self) -> int:
        raise NotImplementedError

    def attach_consumer(self, name: str) -> int:
        """Register consumer ``name`` at the current head; returns it."""
        if name in self._consumers:
            raise ValueError(f"consumer {name!r} already attached")
        self._consumers[name] = self._stream_head()
        return self._consumers[name]

    def detach_consumer(self, name: str) -> None:
        """Drop ``name``'s cursor (a cached batch stays for its peers)."""
        self._consumers.pop(name, None)

    def consumer_cursor(self, name: str) -> int:
        return self._consumers[name]

    def _serve_for(self, name: str, serve: Callable[[], Any]) -> Any:
        """The batch at ``name``'s cursor, advancing it: ``serve()`` for
        the first consumer at the head, the cached batch for its peers."""
        cur = self._consumers[name]
        head = self._stream_head()
        if cur == self._fanout_seq:
            batch = self._fanout_batch
        elif cur == head:
            batch = serve()
            self._fanout_seq, self._fanout_batch = cur, batch
        else:
            raise RuntimeError(
                f"fan-out consumer {name!r} at position {cur} is out of lockstep "
                f"(cached={self._fanout_seq}, head={head}): consumers must drain each "
                f"stream position together")
        self._consumers[name] = cur + 1
        return batch

    def _consumer_state(self) -> dict[str, Any]:
        """``{"consumers": {name: positions behind the head}}`` (0 between
        rounds), or ``{}`` with no consumer attached."""
        if not self._consumers:
            return {}
        head = self._stream_head()
        return {"consumers": {n: head - c for n, c in sorted(self._consumers.items())}}

    def _realign_consumers(self, state: dict[str, Any]) -> None:
        """After a restore: drop the cached batch (it belongs to the
        superseded stream) and put every attached consumer at the restored
        head, as far behind it as the saved state says. The cache is not
        saved, so a consumer saved behind the head (mid-round) raises
        :class:`ValueError`."""
        self._fanout_batch, self._fanout_seq = None, -1
        lags = state.get("consumers") or {}
        behind = {n: lag for n, lag in lags.items() if lag and n in self._consumers}
        if behind:
            raise ValueError(f"fan-out consumers {behind} were saved behind the stream head "
                             f"(mid-round); the cached batch is not saved, so save between "
                             f"rounds")
        head = self._stream_head()
        for name in self._consumers:
            self._consumers[name] = head
