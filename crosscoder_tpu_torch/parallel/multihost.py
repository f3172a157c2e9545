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

The elastic half (``cfg.elastic``; :mod:`crosscoder_tpu_torch.resilience.elastic`
drives it): :func:`elastic_initialize` joins a world that can outlive a
host, on a c10d ``TCPStore`` that rank 0 hosts, so the store dies with its
host as the JAX coordination service does. Membership is versioned by a
monotone epoch (:class:`Membership`); each epoch's process group lives
under a ``PrefixStore`` named for the epoch, and every liveness key embeds
the epoch, so a peer of epoch N never meets a barrier of epoch N+1.
:func:`shrink_to_local` narrows the world to the coordinator host's ranks;
:func:`grow_to` widens it again on the same store, which lives on with
rank 0 through the shrink (JAX's coordination service dies with it, so the
JAX grow starts a fresh one on a new port).
"""

from __future__ import annotations

import dataclasses
import datetime
import gc
import os
import sys
import threading

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


def _backend_kwargs(dev: torch.device, backend: str | None) -> tuple[str, dict]:
    """The backend for ``dev`` (NCCL for a CUDA device, which becomes the
    current device and, under NCCL, the group's ``device_id``; gloo for
    the CPU), or ``backend`` when the caller names one."""
    kwargs: dict = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if backend is None:
            backend = "nccl"
        if backend == "nccl":
            kwargs["device_id"] = dev
    elif dev.type == "cpu":
        backend = backend or "gloo"
    else:
        raise ValueError(f"no process-group backend for device {dev}")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be nccl|gloo, got {backend!r}")
    return backend, kwargs


def initialize(device=None, *, init_method: str | None = None, store=None,
               world_size: int | None = None, rank: int | None = None,
               backend: str | None = None) -> bool:
    """Join the process group; returns True when more than one rank runs.

    Joining is explicit, as in the JAX package (its
    ``JAX_COORDINATOR_ADDRESS``/``CROSSCODER_MULTIHOST`` rule): torchrun's
    ``WORLD_SIZE``, ``RANK`` and ``MASTER_ADDR`` in the environment, or
    ``init_method``/``store`` with ``world_size`` and ``rank``. Anything
    else is a no-op and returns False, so the same entry point runs a
    single process. A group already joined is kept. The backend is NCCL
    for a CUDA device (which becomes the current device and the group's
    ``device_id``), gloo for the CPU; a caller may name ``backend`` (gloo
    ranks sharing one card). One never stands in for the other."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    explicit = init_method is not None or store is not None
    if not explicit and not all(k in os.environ for k in _ENV):
        return False
    dev = local_device(device)
    backend, kwargs = _backend_kwargs(dev, backend)
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
    """Leave the process group (nothing when none was joined), and the
    elastic membership with it."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _elastic.reset()


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


# ---------------------------------------------------------------------------
# Elastic membership (cfg.elastic; resilience/elastic.py drives this layer),
# the JAX module's elastic half.
#
# The JAX package builds its coordination service by hand so that a missed
# heartbeat does not terminate the survivor, then pushes the heartbeat window
# far past any detect-and-remesh time: its bounded probe barriers and the
# torn-collective confirmation are the only live detection. The port needs no
# heartbeat thread for the same outcome: nothing here terminates a process
# when a peer dies, and the probes below are the detection.
# ``elastic_heartbeat_s`` keeps its one live role, the controller's
# slow-probe threshold.


@dataclasses.dataclass(frozen=True)
class Membership:
    """One epoch of the membership view."""

    epoch: int
    num_processes: int
    process_id: int
    coordinator_address: str | None


class _ElasticState:
    def __init__(self) -> None:
        self.peer_lost = threading.Event()
        self.reset()

    def reset(self) -> None:
        self.membership: Membership | None = None
        self.store = None               # the TCPStore rank 0 hosts
        self.rank = 0                   # this process's rank in the gang-start world
        self.local_world_size = 1       # ranks a host: the survivor set's size
        self.device: torch.device | None = None
        self.backend: str | None = None
        self.timeout_s = 0.0            # each epoch's collective timeout
        self.last_epoch = -1            # the newest epoch whose prefix was written to
        self.peer_lost.clear()


_elastic = _ElasticState()


def _log(msg: str) -> None:
    print(f"[crosscoder_tpu_torch] elastic: {msg}"[:400], flush=True, file=sys.stderr)


def _join_epoch(epoch: int, world: int, rank_: int) -> None:
    """Join epoch ``epoch``'s process group: ``world`` ranks under the
    epoch's prefix of the membership store.

    After a loss the survivors reach the join at different times: one may
    still sit in a collective of the old world, blocked on a survivor that
    already left it, until that collective's bound (``timeout_s``) and the
    confirming barrier have run out. So a later epoch first waits for every
    survivor's arrival key for twice the bound, longer than the group's own
    rendezvous would.

    An epoch whose join failed (a grow whose joiner vanished) is burned:
    its prefix may hold arrival keys, so no later join reuses it
    (:func:`next_epoch`)."""
    st = _elastic
    st.last_epoch = max(st.last_epoch, epoch)
    store = dist.PrefixStore(f"epoch{epoch}", st.store)
    if epoch > 0:
        store.set(f"arrived/{rank_}", b"1")
        store.wait([f"arrived/{r}" for r in range(world)],
                   datetime.timedelta(seconds=2 * st.timeout_s))
    backend, kwargs = _backend_kwargs(st.device, st.backend)
    dist.init_process_group(backend, store=store, world_size=world, rank=rank_,
                            timeout=group_timeout(), **kwargs)


def next_epoch() -> int:
    """The epoch after both the current one and every burned one."""
    m = _elastic.membership
    return max(-1 if m is None else m.epoch, _elastic.last_epoch) + 1


def group_timeout() -> datetime.timedelta | None:
    """The bound of each collective of the elastic world, for every group
    made in it (``None`` outside one: PyTorch's default). A subgroup does
    not inherit the world group's timeout, so :mod:`.mesh` passes this."""
    return datetime.timedelta(seconds=_elastic.timeout_s) if _elastic.timeout_s else None


def elastic_initialize(coordinator_address: str, num_processes: int, process_id: int, *,
                       device=None, backend: str | None = None, timeout_s: float = 60.0,
                       local_world_size: int | None = None) -> Membership:
    """Join an ``num_processes``-rank world that can SURVIVE member loss,
    at epoch 0.

    ``coordinator_address`` (``host:port``) is where rank 0 hosts the
    membership ``TCPStore``: the other ranks connect to it, and the
    survivors' later epochs rendezvous on it, so only rank 0's host can
    survive (the store dies with its host, as the JAX coordination
    service does). The backend follows ``device`` as :func:`initialize`'s
    does (``backend`` names it), but an NCCL world of more than one rank is
    refused: a collective torn by a dead NCCL peer does not raise in
    Python (the process group's watchdog ends the process at the timeout),
    so no survivor would reach the confirmation and the shrink.
    ``timeout_s`` bounds each collective of the world and of every group
    made in it (a collective blocked on a live peer that has left waits it
    out) and each store wait. ``local_world_size`` (default
    ``LOCAL_WORLD_SIZE``, else 1) is the ranks a host; ranks are
    host-major, so the survivor set is ranks ``[0, local_world_size)``. No
    heartbeat runs (module comment)."""
    if dist.is_initialized():
        raise RuntimeError("distributed runtime already initialized")
    if local_world_size is None:
        local_world_size = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
    if num_processes % local_world_size:
        raise ValueError(f"local_world_size {local_world_size} must divide the world "
                         f"{num_processes}")
    dev = local_device(device)
    backend_name, _ = _backend_kwargs(dev, backend)
    if backend_name == "nccl" and num_processes > 1:
        raise ValueError(
            "elastic membership over NCCL needs one rank: a dead NCCL peer does not "
            "raise in Python (the watchdog ends the process at the timeout), so a "
            "survivor could not re-mesh; join the ranks with backend='gloo'")
    host, port = coordinator_address.rsplit(":", 1)
    st = _elastic
    st.reset()
    st.device = dev
    st.backend = backend
    st.timeout_s = float(timeout_s)
    st.rank = process_id
    st.local_world_size = local_world_size
    st.store = dist.TCPStore(host, int(port), num_processes, process_id == 0,
                             timeout=datetime.timedelta(seconds=timeout_s))
    _join_epoch(0, num_processes, process_id)
    st.membership = Membership(epoch=0, num_processes=num_processes, process_id=process_id,
                               coordinator_address=coordinator_address)
    return st.membership


def membership() -> Membership | None:
    """The current membership view (None outside an elastic runtime)."""
    return _elastic.membership


def collective_timeout_s() -> float:
    """The bound of each collective of the elastic world (0 outside one)."""
    return _elastic.timeout_s


def backend_name() -> str | None:
    """The elastic world's backend (``None`` outside one)."""
    st = _elastic
    return None if st.device is None else _backend_kwargs(st.device, st.backend)[0]


def local_world_size() -> int:
    """The ranks a host of the elastic world (1 outside one)."""
    return _elastic.local_world_size


def on_coordinator_host() -> bool:
    """True on the ranks a shrink keeps: rank 0's host's (``[0,
    local_world_size)``)."""
    return _elastic.rank < _elastic.local_world_size


def peer_loss_flagged() -> bool:
    """True once a failed liveness barrier has recorded a dead peer (the
    flag latches at the first timed-out barrier)."""
    return _elastic.peer_lost.is_set()


def clear_peer_loss() -> None:
    """Clear the peer-loss flag after the controller ABSORBS a failed probe
    (hysteresis: a flaky or slow host below the ``elastic_suspect_probes``
    threshold gets another probe; a latched flag would short-circuit every
    later probe to False). Never needed once loss is declared:
    :func:`shrink_to_local` resets the flag itself."""
    _elastic.peer_lost.clear()


def probe_liveness(seq, timeout_s: float) -> bool:
    """One bounded membership barrier on the store: True when every rank of
    the current epoch arrived within ``timeout_s``. Each rank sets its key
    and waits for all of them; the keys embed ``(epoch, seq)`` so the probe
    is SPMD-consistent (every rank calls it with the same ``seq``, a step
    index) and cannot collide across epochs. A timeout, or a store gone
    with its host, fails the probe and latches the peer-loss flag."""
    m = _elastic.membership
    if m is None or m.num_processes <= 1:
        return True
    if _elastic.peer_lost.is_set():
        return False
    key = f"crosscoder_tpu_elastic_{m.epoch}_{seq}"
    try:
        _elastic.store.set(f"{key}/{m.process_id}", b"1")
        _elastic.store.wait([f"{key}/{r}" for r in range(m.num_processes)],
                            datetime.timedelta(seconds=max(timeout_s, 1e-3)))
        return True
    except Exception as e:  # noqa: BLE001 — a timeout or a dead store both mean loss
        _log(f"liveness barrier {m.epoch}/{seq} failed ({type(e).__name__}: {e})")
        _elastic.peer_lost.set()
        return False


def _leave_group() -> None:
    """Leave every group of the current epoch. Under NCCL the groups are
    aborted, not destroyed politely; gloo's close their connections once
    nothing refers to them any more (the caller drops its references
    first), so a survivor still blocked on this rank in one of their
    collectives fails at once instead of at the bound."""
    if not dist.is_initialized():
        return
    if dist.get_backend() == "nccl":
        abort = getattr(dist.distributed_c10d, "_abort_process_group", None)
        if abort is not None:
            abort()
            return
    dist.destroy_process_group()
    gc.collect()


def shrink_to_local() -> Membership:
    """Tear the world down to the coordinator host's ranks (``[0,
    local_world_size)``), bumping the epoch: leave the old groups, then
    join a new group of just those ranks under the next epoch's prefix of
    the same store (past any epoch a failed grow burned). The flag is
    cleared.

    Only the coordinator host's ranks can shrink (the store lives on rank
    0); any other rank raises :class:`RuntimeError`. Device tensors outlive
    the teardown, unlike the JAX backend reset, but callers must treat
    every value a collective of the old world touched as unknown and
    rebuild from a verified save (the elastic controller restores)."""
    old = _elastic.membership
    if old is None:
        raise RuntimeError("shrink_to_local outside an elastic runtime")
    survivors = _elastic.local_world_size
    if not on_coordinator_host():
        raise RuntimeError(f"rank {_elastic.rank} is not on the coordinator host "
                           f"(ranks 0..{survivors - 1}); it cannot shrink")
    try:
        _leave_group()
    except Exception as e:  # noqa: BLE001 — the peers are gone: a teardown may fail
        _log(f"group teardown ({type(e).__name__}: {e})")
    new = Membership(epoch=next_epoch(), num_processes=survivors,
                     process_id=_elastic.rank, coordinator_address=old.coordinator_address)
    _join_epoch(new.epoch, survivors, _elastic.rank)
    _elastic.peer_lost.clear()
    _elastic.membership = new
    return new


def grow_to(coordinator_address: str, num_processes: int, process_id: int, epoch: int, *,
            device=None, backend: str | None = None, timeout_s: float | None = None,
            local_world_size: int | None = None) -> Membership:
    """Re-form a WIDER world of ``num_processes`` ranks at ``epoch``, on the
    membership store at ``coordinator_address``.

    Two callers share this entry point:

    - a survivor (a rank of the shrunk world, which holds the store or a
      client of it): it leaves its narrow groups first (:func:`_leave_group`;
      the caller drops its references to them before), then joins the new
      epoch at its own rank, which it keeps (ranks are host-major: the
      survivors are ``[0, local_world_size)``);
    - a returned joiner (a fresh process): it connects to the store as a
      client and joins at ``process_id``, the rank its admit record gives
      it. ``device``, ``backend``, ``timeout_s`` (the collective bound) and
      ``local_world_size`` are the world's, from the same record; a
      survivor keeps its own.

    The join is :func:`_join_epoch`'s: an arrival barrier bounded by twice
    the collective bound, then the group's own rendezvous. It raises when
    a member does not arrive (the joiner vanished); the caller then burns
    the epoch and re-forms narrow (:func:`shrink_to_local`, which joins past
    it). ``epoch`` must be past the current one, and the target world must
    have at least 2 ranks (:class:`ValueError`); an NCCL world of more than
    one rank is refused, as :func:`elastic_initialize` refuses it."""
    if num_processes < 2:
        raise ValueError(f"grow_to needs a multi-process target world, got "
                         f"num_processes={num_processes}")
    st = _elastic
    old = st.membership
    if old is not None and epoch <= old.epoch:
        raise ValueError(f"grow_to epoch {epoch} is not past the current epoch {old.epoch}: "
                         "mesh epochs are monotone")
    if old is None:
        # a returned joiner: the world's settings, then a client of its store
        if dist.is_initialized():
            raise RuntimeError("grow_to on a process that has joined a group outside an "
                               "elastic runtime")
        dev = local_device(device)
        L = int(local_world_size or os.environ.get("LOCAL_WORLD_SIZE", 1))
        if num_processes % L:
            raise ValueError(f"local_world_size {L} must divide the world {num_processes}")
        st.reset()
        st.device, st.backend, st.rank, st.local_world_size = dev, backend, process_id, L
        st.timeout_s = float(timeout_s if timeout_s is not None else 60.0)
    if _backend_kwargs(st.device, st.backend)[0] == "nccl":
        raise ValueError(
            "elastic membership over NCCL needs one rank: a dead NCCL peer does not raise in "
            "Python, so a survivor could not re-mesh; join the ranks with backend='gloo'")
    if old is None:
        host, port = coordinator_address.rsplit(":", 1)
        st.store = dist.TCPStore(host, int(port), is_master=False,
                                 timeout=datetime.timedelta(seconds=st.timeout_s))
    else:
        if process_id != st.rank:
            raise ValueError(f"a survivor keeps its rank {st.rank} in the grown world, got "
                             f"{process_id}")
        try:
            _leave_group()
        except Exception as e:  # noqa: BLE001 — the narrow world is left either way
            _log(f"group teardown ({type(e).__name__}: {e})")
    _join_epoch(epoch, num_processes, process_id)
    st.peer_lost.clear()
    st.membership = Membership(epoch=epoch, num_processes=num_processes, process_id=process_id,
                               coordinator_address=coordinator_address)
    return st.membership


def share_from_coordinator(key: str, payload: bytes | None, timeout_s: float) -> bytes | None:
    """Rank 0's ``payload`` on every rank of the current epoch: rank 0
    writes it under ``key`` (which names the epoch and the occasion: a key
    is written once) and returns it; every other rank waits up to
    ``timeout_s`` for it and returns it, or ``None`` when it did not come.
    One rank: ``payload`` itself."""
    m = _elastic.membership
    if m is None or m.num_processes <= 1:
        return payload
    k = f"crosscoder_tpu_share_{m.epoch}_{key}"
    if m.process_id == 0:
        _elastic.store.set(k, payload)
        return payload
    try:
        _elastic.store.wait([k], datetime.timedelta(seconds=max(timeout_s, 1e-3)))
        return _elastic.store.get(k)
    except Exception as e:  # noqa: BLE001 — a timeout or a dead store: nothing shared
        _log(f"no word from rank 0 under {key} ({type(e).__name__}: {e})")
        return None
