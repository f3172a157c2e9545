"""Stacked-tenant plumbing for the fleet scheduler
(:mod:`crosscoder_tpu_torch.train.fleet`), ported from
:mod:`crosscoder_tpu.models.stacked`.

A fleet cohort is a group of tenants that differ only in ``seed`` and
``l1_coeff``: their :class:`~crosscoder_tpu_torch.train.state.TrainState`
leaves stack on a leading tenant axis of N (:func:`stack_states`), and a
cohort step (:func:`cohort_step`) trains them all on one served batch:

- each member's loss and gradients come from its own solo step body
  (:func:`crosscoder_tpu_torch.train.trainer.make_step_body` over the
  member's config, so its L1 coefficient is its solo run's), run on
  views of the stacked leaves (:func:`unstack_state`), so the member
  launches the solo step's kernels as a solo step would: the fused,
  sparse and TopK tiers gate on ``l1_coeff``, so members of one cohort
  may take different tiers, and a BatchTopK threshold stays one
  tenant's;
- each member's global norm is the solo
  :meth:`~crosscoder_tpu_torch.train.state.Optimizer.global_norm` of its
  gradients, so the cohort's ``[N]`` norms are bitwise the solo ones;
- the gradients land in stacked leaves and ONE O1 launch
  (:func:`crosscoder_tpu_torch.ops.adam.adam_update` with the ``[N]``
  norms) updates every member, each clipped by its own norm;
- each member's AuxK bookkeeping writes its own slice of the stacked
  ``aux``.

The JAX package gets the cohort step from ``jax.vmap`` over the step
body. ``torch.func.vmap`` cannot pass through the port's ctypes kernel
launches or ``torch.autograd.grad``, and running plain versions under it
would hide the kernels, so the members' forwards and backwards run one
after another and only the update is batched. The JAX ``l1_input`` body
and ``stacked_l1_vector`` carry the L1 bases into the one vmapped body;
with one body a member here, each body's cfg holds its base, and the
metrics stay one dict a member (no ``stack_metrics``/``unstack_metrics``
round trip). Scalars stay per cohort: the members step in lockstep, so
the step counter and Adam's count are one int each (:func:`stack_states`
refuses states that differ in them).

On a rank grid each member's state is this rank's shards (the mesh
Trainer's), stacked on the leading tenant axis, which no rank splits: the
JAX ``stacked_shardings`` gives each solo spec a leading ``None``, and
here the solo rules shard each member before it is stacked, so
``stacked_shardings`` has no counterpart. The members' step bodies are
the mesh step's and each norm is the member's global norm over the grid
(:meth:`Optimizer.global_norm` with the mesh).
"""

from __future__ import annotations

from typing import Any, Sequence

import torch

from crosscoder_tpu_torch.train.state import AdamState, Optimizer, TrainState


def _map(state: TrainState, fn) -> TrainState:
    """``fn`` over every tensor leaf of ``state`` (params, moments, aux)."""
    opt = state.opt_state
    return TrainState(
        {k: fn(v) for k, v in state.params.items()},
        AdamState(opt.count, {k: fn(v) for k, v in opt.mu.items()},
                  {k: fn(v) for k, v in opt.nu.items()}),
        state.step,
        None if state.aux is None else {k: fn(v) for k, v in state.aux.items()})


def stack_states(states: Sequence[TrainState]) -> TrainState:
    """N structurally identical states stacked leaf-wise on a new leading
    axis (new tensors). :class:`ValueError` for no state, or for states
    whose step or Adam count differ (a cohort steps in lockstep)."""
    if not states:
        raise ValueError("stack_states needs at least one state")
    first = states[0]
    for s in states[1:]:
        if (s.step, s.opt_state.count) != (first.step, first.opt_state.count):
            raise ValueError(
                f"cohort members step in lockstep: step/count {s.step}/{s.opt_state.count} "
                f"!= {first.step}/{first.opt_state.count}")
    if any("quant_ef" in (s.aux or {}) for s in states):
        raise ValueError("a stacked state cannot carry quant_grads residuals")
    opt = first.opt_state

    def stack(get):
        return torch.stack([get(s) for s in states])

    return TrainState(
        {k: stack(lambda s, k=k: s.params[k]) for k in first.params},
        AdamState(opt.count, {k: stack(lambda s, k=k: s.opt_state.mu[k]) for k in opt.mu},
                  {k: stack(lambda s, k=k: s.opt_state.nu[k]) for k in opt.nu}),
        first.step,
        None if first.aux is None else {k: stack(lambda s, k=k: s.aux[k]) for k in first.aux})


def unstack_state(stacked: TrainState, i: int) -> TrainState:
    """Tenant ``i``'s solo state as views of the stacked leaves (writes to
    it land in the stack)."""
    return _map(stacked, lambda a: a[i])


def write_member(stacked: TrainState, i: int, member: TrainState) -> None:
    """Copy ``member``'s leaves into tenant ``i``'s slices of ``stacked``
    (a member edited apart, as a resample edits it)."""
    view = unstack_state(stacked, i)
    for got, put in ((view.params, member.params), (view.opt_state.mu, member.opt_state.mu),
                     (view.opt_state.nu, member.opt_state.nu), (view.aux or {}, member.aux or {})):
        for k, t in put.items():
            if got[k].data_ptr() != t.data_ptr():
                got[k].copy_(t)


def restack_without(stacked: TrainState, i: int) -> TrainState:
    """``stacked`` without tenant ``i`` (retirement: the survivors' values
    carry over)."""
    return _map(stacked, lambda a: torch.cat([a[:i], a[i + 1:]]))


@torch.no_grad()
def _copy_grads(into: dict[str, torch.Tensor], i: int, grads: dict[str, torch.Tensor]) -> None:
    for k, g in grads.items():
        into[k][i].copy_(g)


def cohort_step(bodies: Sequence[Any], opt: Optimizer, state: TrainState, batch: torch.Tensor,
                scale: torch.Tensor, mesh=None) -> tuple[TrainState, list[dict[str, Any]]]:
    """One step of a cohort, in place on the stacked ``state``: member
    ``i``'s loss and gradients from ``bodies[i]`` (the step body of its
    own cfg) on its views, its gradients copied into stacked leaves as
    soon as they exist, each member's global norm (over ``mesh``'s shards,
    the gradients already summed over ``data``), one O1 launch over the
    stacked leaves with the ``[N]`` norms, then each member's AuxK
    bookkeeping into its slice. Returns the state (the same tensors) and
    one metrics dict a member."""
    grads = {k: torch.empty_like(v) for k, v in state.params.items()}
    norms, parts = [], []
    for i, body in enumerate(bodies):
        view = unstack_state(state, i)
        loss, losses, g, dead, _ = body.loss_and_grads(view, batch, scale)
        norms.append(Optimizer.global_norm(g, mesh, opt.shard_sources))
        _copy_grads(grads, i, g)
        del g
        parts.append((view, loss, losses, dead))
    params, new_opt = opt.update(grads, state.opt_state, state.params, donate=True,
                                 norm=torch.stack(norms))
    del grads
    metrics = []
    for body, (view, loss, losses, dead) in zip(bodies, parts):
        member, m = body.finish(view, view.params, view.opt_state, loss, losses, dead)
        for k, t in (member.aux or {}).items():
            if view.aux[k].data_ptr() != t.data_ptr():
                view.aux[k].copy_(t)
        metrics.append(m)
    return TrainState(params, new_opt, state.step + 1, state.aux), metrics
