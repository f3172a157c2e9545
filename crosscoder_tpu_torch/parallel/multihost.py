"""Multi-process start-up, ported from :mod:`crosscoder_tpu.parallel.multihost`
(``initialize``, ``needs_launch_tickets``, ``is_primary``,
``process_info``, ``put_global``) onto ``torch.distributed``.

One process a device: ``torchrun --nproc-per-node N -m
crosscoder_tpu_torch.train.main ...`` starts N ranks, and each calls
:func:`initialize` first. The backend follows the device: NCCL for
``cuda:LOCAL_RANK`` (the default), gloo for ``device="cpu"``; one never
stands in for the other.

Host-side singletons (the metrics logger, checkpoint writes) run on the
primary rank only (:func:`is_primary`); device work needs no gating, as
every rank runs the same program.

Not ported yet: the elastic half of the JAX module (membership epochs,
survivor re-mesh).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

_ENV = ("WORLD_SIZE", "RANK", "MASTER_ADDR")


def local_device(device=None) -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` when ``device`` is ``None``
    (``LOCAL_RANK`` 0 outside ``torchrun``), else ``device``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card by default; pass "
                "device='cpu' to run the plain PyTorch paths on the CPU")
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return torch.device(device)


def initialize(device=None, *, init_method: str | None = None, store=None,
               world_size: int | None = None, rank: int | None = None) -> bool:
    """Join the process group; returns True when more than one rank runs.

    Joining is explicit, as in the JAX package (its
    ``JAX_COORDINATOR_ADDRESS``/``CROSSCODER_MULTIHOST`` rule): torchrun's
    ``WORLD_SIZE``, ``RANK`` and ``MASTER_ADDR`` in the environment, or
    ``init_method``/``store`` with ``world_size`` and ``rank``. Anything
    else is a no-op and returns False, so the same entry point runs a
    single process. A group already joined is kept. The backend is NCCL
    for a CUDA device (which becomes the current device and the group's
    ``device_id``), gloo for the CPU."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    explicit = init_method is not None or store is not None
    if not explicit and not all(k in os.environ for k in _ENV):
        return False
    dev = local_device(device)
    kwargs: dict = {}
    if dev.type == "cuda":
        backend = "nccl"
        torch.cuda.set_device(dev)
        kwargs["device_id"] = dev
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for device {dev}")
    if store is not None:
        kwargs["store"] = store
    else:
        kwargs["init_method"] = init_method or "env://"
    if world_size is not None:
        kwargs["world_size"] = world_size
    if rank is not None:
        kwargs["rank"] = rank
    dist.init_process_group(backend, **kwargs)
    return dist.get_world_size() > 1


def shutdown() -> None:
    """Leave the process group (nothing when none was joined)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def needs_launch_tickets() -> bool:
    """True when concurrent launches must be ordered across ranks (more
    than one rank): every rank must issue the same collectives in the same
    order."""
    return world_size() > 1


def is_primary() -> bool:
    """True on the rank that owns host-side singletons (checkpoint writes,
    metric logging)."""
    return rank() == 0


def process_info() -> dict[str, int]:
    """One device a rank: the global devices are the ranks."""
    local = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return {"process_index": rank(), "process_count": world_size(),
            "local_devices": int(os.environ.get("LOCAL_WORLD_SIZE", local)),
            "global_devices": world_size()}


def local_shard(tree, specs):
    """This rank's shard of a host value every rank built identically
    (seeded init, a checkpoint's arrays): each leaf narrowed along its
    spec's ``(dim, n, i)`` (the ``i``-th of ``n`` equal slices; ``None``
    keeps the leaf whole) into memory of its own. No communication, as
    the JAX ``put_global``. ``tree`` and ``specs`` are nested dicts (or a
    leaf and its spec). A tensor leaf is copied even when kept whole, so
    an update in place on one rank's state never reaches the value it
    came from."""
    if isinstance(tree, dict):
        return {k: local_shard(v, specs[k]) for k, v in tree.items()}
    if not torch.is_tensor(tree):
        return tree
    if specs is None:
        return tree.clone()
    dim, n, i = specs
    size = tree.shape[dim]
    if size % n:
        raise ValueError(f"axis {dim} of size {size} does not split into {n} shards")
    return tree.narrow(dim, i * (size // n), size // n).clone(
        memory_format=torch.contiguous_format)
