"""Row operations of the replay store, the port's own copy of the JAX
package's ``native`` row ops (``gather_rows``, ``gather_scale_f32``,
``scatter_rows``), on torch tensors in host RAM or on the device.

The results are byte-identical to that module's numpy fallback
(``store[idx]``, ``store[idx].astype(f32) * scale[None, :, None]``,
``store[pos] = rows``); ``torch.index_select``/``index_copy_`` run them on
all the host's cores, or on the card for a device store. Indices come as
numpy and follow numpy's rules: negatives in ``[-n, -1]`` wrap, anything
outside ``[-n, n)`` raises :class:`IndexError`. They are checked on the
host and then copied to the store's device, so no call waits on the card.
"""

from __future__ import annotations

import numpy as np
import torch


def _index(idx, store: torch.Tensor, name: str = "idx") -> torch.Tensor:
    n = store.shape[0]
    idx = np.asarray(idx, dtype=np.int64)
    if idx.size:
        lo, hi = int(idx.min()), int(idx.max())
        if lo < -n or hi >= n:
            raise IndexError(f"{name} out of range for store of {n} rows")
        if lo < 0:
            idx = np.where(idx < 0, idx + n, idx)
    return torch.as_tensor(idx, device=store.device)


def gather_rows(store: torch.Tensor, idx, pin: bool = False) -> torch.Tensor:
    """``store[idx]`` (any trailing shape); ``pin``: into page-locked host
    memory (a host store feeding a card)."""
    i = _index(idx, store)
    if not pin:
        return torch.index_select(store, 0, i)
    out = torch.empty((i.numel(), *store.shape[1:]), dtype=store.dtype, pin_memory=True)
    return torch.index_select(store, 0, i, out=out)


def gather_scale_f32(store: torch.Tensor, idx, scale) -> torch.Tensor:
    """``store[idx].float() * scale[None, :, None]`` for a ``[N, n_sources,
    d_in]`` store and ``scale [n_sources]``."""
    if store.dim() != 3:
        raise ValueError(f"store must be [N, n_sources, d_in], got {tuple(store.shape)}")
    scale = torch.as_tensor(np.asarray(scale, dtype=np.float32), device=store.device)
    if scale.shape != (store.shape[1],):
        raise ValueError(f"scale must be [{store.shape[1]}], got {tuple(scale.shape)}")
    return gather_rows(store, idx).float() * scale[None, :, None]


def scatter_rows(store: torch.Tensor, pos, rows: torch.Tensor) -> None:
    """``store[pos] = rows`` in place."""
    if rows.dtype != store.dtype or rows.shape[1:] != store.shape[1:]:
        raise ValueError(f"rows {tuple(rows.shape)}/{rows.dtype} does not match store "
                         f"{tuple(store.shape)}/{store.dtype}")
    store.index_copy_(0, _index(pos, store, "pos"), rows.contiguous())
