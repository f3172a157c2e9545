"""A bounded in-flight window for device→host streaming loops, ported from
:mod:`crosscoder_tpu.utils.pipeline` (``drive`` and ``DEFAULT_DEPTH``).

In PyTorch "in flight" means work queued on the stream before the host
reads a result back: a producer that dispatches a chunk's kernels and
returns device tensors lets the card run ahead while the host drains an
earlier chunk, and the bounded window keeps queued intermediates from
piling up.
"""

from __future__ import annotations

from typing import Callable, Iterable, TypeVar

T = TypeVar("T")

# chunks kept in flight: device compute overlaps the host's reads of
# earlier chunks (1 = fully serial)
DEFAULT_DEPTH = 3


def drive(produced: Iterable[T], drain: Callable[[T], None], depth: int = DEFAULT_DEPTH) -> None:
    """Consume ``produced`` (an iterator that dispatches device work as it
    advances) keeping at most ``depth`` items in flight, calling ``drain``
    on each in FIFO order."""
    inflight: list[T] = []
    for item in produced:
        inflight.append(item)
        if len(inflight) >= depth:
            drain(inflight.pop(0))
    for item in inflight:
        drain(item)
