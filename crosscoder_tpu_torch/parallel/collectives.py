"""The collectives of the parallel layer, each counted by op.

Every collective the port issues goes through this module, so a run can
show how many it made (:data:`calls`, keyed ``all_reduce``,
``all_gather``, ``all_to_all``, ``reduce_scatter`` and ``ring_shift``,
the ring attention's hop). A ``group`` of ``None`` is no group at
all: the call is the identity and nothing is issued (a loss computed
rank-locally, as the quantized-gradient step does); the trainer's mesh
always passes real groups, size 1 included, so a one-rank run issues
every collective a wider run does.

Beside the calls, :data:`bytes` counts what each collective delivers,
keyed by op as :data:`calls` is: the reduced tensor of an all-reduce,
the gathered result of an all-gather, the shard a reduce-scatter keeps,
an all-to-all's output and the payload a ring hop receives (the JAX
``collective_bytes`` counts the same output shapes out of HLO). A group
of one rank moves nothing: its calls count, its bytes do not.
:mod:`crosscoder_tpu_torch.parallel.comm_model` reads these counts.

Each counted call also hands its input and outputs to :data:`fill` when
one is installed: ``comm_model.profile_width`` installs one while its
group of PyTorch's fake backend (which writes no output) exists.

The two differentiable collectives (the JAX package gets them from
GSPMD):

- :func:`sum_over`: forward sums over the group, backward is the
  identity. Right when every rank computes the same downstream value from
  the sum (the loss is replicated over the group), so each rank's input
  gets the full cotangent once. ``torch.distributed.nn.functional.
  all_reduce`` sums the cotangent again, which would scale the gradient
  by the group's size.
- :func:`copy_to`: its mirror, forward the identity, backward sums the
  cotangent over the group: a value replicated over the group (a
  parameter over ``data``) used by rank-local work, whose gradient is the
  sum of the ranks' partial gradients.
"""

from __future__ import annotations

from collections import Counter

import torch
import torch.distributed as dist

calls: Counter = Counter()        # collectives issued, by op
bytes: Counter = Counter()        # bytes they delivered, by op (0 on a group of one)
wire_calls: Counter = Counter()   # the calls on groups of more than one rank, by op


# ``fill(op, group, sent, outs)``, run after each collective while set
fill = None


def reset_counts() -> None:
    calls.clear()
    bytes.clear()
    wire_calls.clear()


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _count(op: str, group, sent, *outs: torch.Tensor) -> None:
    calls[op] += 1
    if group_size(group) > 1:
        wire_calls[op] += 1
        bytes[op] += sum(t.numel() * t.element_size() for t in outs)
    if fill is not None:
        fill(op, group, sent, outs)


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced over ``group`` in place (returned)."""
    if group is not None:
        dist.all_reduce(t, op=op, group=group)
        _count("all_reduce", group, t, t)
    return t


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """``[n, *t.shape]``: every rank's ``t`` (at least 1-d), in group-rank
    order."""
    if group is None:
        return t.unsqueeze(0)
    n = group_size(group)
    t = t.contiguous()
    out = torch.empty((n * t.shape[0], *t.shape[1:]), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t, group=group)
    _count("all_gather", group, t, out)
    return out.reshape(n, *t.shape)


def all_gather_cat(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in group-rank order."""
    if group is None:
        return t
    g = all_gather(t, group)                              # [n, ...]
    return torch.cat(list(g.unbind(0)), dim=dim)


def all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """``t [n, ...]``: row ``j`` goes to rank ``j``; returns the rows every
    rank sent here, in group-rank order."""
    if group is None:
        return t
    t = t.contiguous()
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group)
    _count("all_to_all", group, t, out)
    return out


def reduce_scatter(t: torch.Tensor, group) -> torch.Tensor:
    """``t [n·r, ...]`` summed over ``group``; this rank keeps its ``r``
    rows (group-rank order)."""
    if group is None:
        return t
    n = group_size(group)
    t = t.contiguous()
    out = torch.empty((t.shape[0] // n, *t.shape[1:]), dtype=t.dtype, device=t.device)
    dist.reduce_scatter_tensor(out, t, group=group)
    _count("reduce_scatter", group, t, out)
    return out


def ring_shift_start(tensors, group):
    """Send each of ``tensors`` to the next rank of ``group`` (group rank
    ``r + 1`` mod ``n``) and receive the previous rank's, without waiting:
    returns the pending exchange, which :func:`ring_shift_wait` completes
    into the received tensors. One batched point-to-point call for all the
    tensors."""
    n = group_size(group)
    r = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (r + 1) % n)
    prv = dist.get_global_rank(group, (r - 1) % n)
    send = [t.contiguous() for t in tensors]     # alive until the wait
    recv = [torch.empty_like(t) for t in send]
    ops = [dist.P2POp(dist.isend, t, nxt, group) for t in send]
    ops += [dist.P2POp(dist.irecv, t, prv, group) for t in recv]
    reqs = dist.batch_isend_irecv(ops)
    _count("ring_shift", group, send, *recv)
    return reqs, recv, send


def ring_shift_wait(pending) -> list[torch.Tensor]:
    reqs, recv, _ = pending
    for q in reqs:
        q.wait()
    return recv


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return all_reduce_(t.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


def sum_over(t: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group``; the backward passes the cotangent through."""
    if group is None:
        return t
    return _SumOver.apply(t, group)


def copy_to(t: torch.Tensor, group) -> torch.Tensor:
    """The identity; the backward sums the cotangent over ``group``."""
    if group is None:
        return t
    return _CopyTo.apply(t, group)
