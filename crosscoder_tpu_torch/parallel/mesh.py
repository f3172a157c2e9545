"""The ``data`` × ``model`` rank grid and the sharding rules of the train
state, ported from :mod:`crosscoder_tpu.parallel.mesh`.

Ranks lay out as the JAX package's ``Mesh`` lays devices: rank ``r`` sits
at ``(r // model, r % model)``. ``data`` shards the batch rows (each
``data`` rank trains its slice of every global batch); ``model`` shards the
dictionary axis ``d_hidden`` of ``W_enc``, ``W_dec``, ``b_enc`` and the
latent-axis state (:data:`_PARAM_SPECS`, the JAX package's
``PartitionSpec`` tuples). Everything else is replicated; the quantized
exchange's residuals ``quant_ef`` ``[n_data, L]`` split over ``data``.
Under ``shard_sources`` (:data:`_SOURCE_SPECS`) ``model`` shards the
SOURCE axis instead: ``W_enc`` on dim 0, ``W_dec`` on dim 1, ``b_dec`` on
dim 0; the latent-axis leaves are replicated.

:class:`Mesh` holds this rank's coordinates and the process groups; its
helpers are the reductions the step and the loss make over an axis. The
sharding mode is ``cfg.shard_sources`` alone: every consumer that picks
the rules holds the config and passes the flag.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable

import torch
import torch.distributed as dist

from crosscoder_tpu_torch.parallel import collectives as coll
from crosscoder_tpu_torch.parallel import multihost

# leaf name → the JAX PartitionSpec as a tuple of mesh axes, one per dim
_PARAM_SPECS: dict[str, tuple] = {
    "W_enc": (None, None, "model"),
    "W_dec": ("model", None, None),
    "b_enc": ("model",),
    "b_dec": (None, None),
    "log_theta": ("model",),
    # AuxK dead-latent tracker and its cached mask: latent axis, like b_enc
    "steps_since_fired": ("model",),
    "dead_mask": ("model",),
}
# cfg.shard_sources: whole source slabs a rank, the dictionary replicated;
# the encode's contraction over sources becomes a sum over ``model``
_SOURCE_SPECS: dict[str, tuple] = {
    "W_enc": ("model", None, None),
    "W_dec": (None, "model", None),
    "b_enc": (None,),
    "b_dec": ("model", None),
    "log_theta": (None,),
    "steps_since_fired": (None,),
    "dead_mask": (None,),
}
_EF_SPEC = ("data", None)


def _specs(shard_sources: bool = False) -> dict[str, tuple]:
    return _SOURCE_SPECS if shard_sources else _PARAM_SPECS


def param_spec(name: str, shard_sources: bool = False) -> tuple:
    try:
        return _specs(shard_sources)[name]
    except KeyError:
        raise ValueError(f"no sharding rule for param {name!r}") from None


def shard_dim(spec: tuple) -> tuple[int, str] | None:
    """``(dim, axis)`` a spec shards, or ``None`` when replicated."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            return dim, axis
    return None


@dataclass(frozen=True)
class Mesh:
    """This rank's place in the grid and its groups. A group of ``None``
    (:meth:`local`) makes that axis's reductions the identity."""

    data_size: int
    model_size: int
    data_rank: int
    model_rank: int
    data_group: Any
    model_group: Any
    world_group: Any

    def size(self, axis: str) -> int:
        return self.data_size if axis == "data" else self.model_size

    def index(self, axis: str) -> int:
        return self.data_rank if axis == "data" else self.model_rank

    def group(self, axis: str):
        return self.data_group if axis == "data" else self.model_group

    def local(self) -> "Mesh":
        """The same rank with no ``data`` reductions: a loss computed on
        this rank's rows alone (the quantized-gradient step)."""
        return replace(self, data_size=1, data_rank=0, data_group=None,
                       world_group=self.model_group)

    def dict_view(self) -> "Mesh":
        """The grid as the dictionary sees it under ``shard_sources``: the
        latents replicated over ``model``, so the selection and the latent
        statistics reduce over ``data`` only."""
        return replace(self, model_size=1, model_rank=0, model_group=None,
                       world_group=self.data_group)

    def source_slice(self, n_sources: int) -> slice:
        """This rank's sources under ``shard_sources``."""
        w = n_sources // self.model_size
        return slice(self.model_rank * w, (self.model_rank + 1) * w)

    # -- reductions the loss and the step make ---------------------------
    def mean_data(self, t: torch.Tensor) -> torch.Tensor:
        """The mean over ``data`` of a per-rank mean (equal shards),
        differentiable (backward: ``g / n_data`` to each rank)."""
        return coll.sum_over(t, self.data_group) / self.data_size

    def sum_model(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over ``model`` of per-rank partials, differentiable."""
        return coll.sum_over(t, self.model_group)

    def sum_world(self, t: torch.Tensor) -> torch.Tensor:
        return coll.sum_over(t, self.world_group)

    def any_(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Elementwise OR over ``axis`` (no gradient)."""
        v = t.detach().to(torch.int32).reshape(-1).clone()
        coll.all_reduce_(v, self.group(axis), dist.ReduceOp.MAX)
        return (v > 0).reshape(t.shape)

    def max_world(self, t: torch.Tensor) -> torch.Tensor:
        return coll.all_reduce_(t.detach().clone(), self.world_group, dist.ReduceOp.MAX)

    def gather_model(self, t: torch.Tensor) -> torch.Tensor:
        """``[model, *t.shape]``: every ``model`` rank's ``t``."""
        return coll.all_gather(t, self.model_group)


def _groups(rows: list[list[int]]) -> list:
    # an elastic world's bound on each collective; a new group does not
    # inherit the world group's timeout
    return [dist.new_group(r, timeout=multihost.group_timeout()) for r in rows]


def make_mesh(data_axis_size: int = -1, model_axis_size: int = 1) -> Mesh:
    """The grid over the joined process group (call
    :func:`~.multihost.initialize` first). ``data_axis_size=-1`` takes
    every rank not claimed by the model axis. Raises as the JAX
    ``make_mesh`` does. Every rank must call this, in the same order (it
    creates groups)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if model_axis_size < 1 or n % model_axis_size:
        raise ValueError(f"model_axis_size {model_axis_size} must divide device count {n}")
    if data_axis_size == -1:
        data_axis_size = n // model_axis_size
    if data_axis_size * model_axis_size != n:
        raise ValueError(f"mesh {data_axis_size}x{model_axis_size} != {n} devices; "
                         "use data_axis_size=-1 to auto-fill")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "crosscoder_tpu_torch.parallel.multihost.initialize() first")
    m = model_axis_size
    r = dist.get_rank()
    model_groups = _groups([[d * m + j for j in range(m)] for d in range(data_axis_size)])
    data_groups = _groups([[d * m + j for d in range(data_axis_size)] for j in range(m)])
    world = _groups([list(range(n))])[0]
    return Mesh(data_size=data_axis_size, model_size=m, data_rank=r // m, model_rank=r % m,
                data_group=data_groups[r % m], model_group=model_groups[r // m],
                world_group=world)


def mesh_from_cfg(cfg) -> Mesh:
    return make_mesh(cfg.data_axis_size, cfg.model_axis_size)


# ---------------------------------------------------------------------------
# the train state's leaves under the rules


def _leaf_spec(kind: str, name: str, leaf: torch.Tensor, shard_sources: bool = False) -> tuple:
    if kind == "quant_ef":
        return _EF_SPEC
    spec = _specs(shard_sources).get(name)
    if spec is None or not torch.is_tensor(leaf) or leaf.dim() != len(spec):
        return ()
    return spec


def _map_state(state, fn: Callable[[str, str, Any], Any]):
    """A TrainState with ``fn(kind, name, leaf)`` applied to every leaf
    (``kind``: params, mu, nu, aux, quant_ef)."""
    from crosscoder_tpu_torch.train.state import AdamState, TrainState

    def tree(kind, d):
        return {k: fn(kind, k, v) for k, v in d.items()}

    aux = None
    if state.aux is not None:
        aux = {k: (tree("quant_ef", v) if k == "quant_ef" else fn("aux", k, v))
               for k, v in state.aux.items()}
    opt = state.opt_state
    return TrainState(tree("params", state.params),
                      AdamState(opt.count, tree("mu", opt.mu), tree("nu", opt.nu)),
                      state.step, aux)


def state_specs(state, shard_sources: bool = False) -> dict[str, tuple]:
    """``{checkpoint key: spec}`` of every tensor leaf of a TrainState, in
    the keys of :func:`crosscoder_tpu_torch.checkpoint.ckpt.flatten_state`
    (the JAX pytree paths): what the JAX ``state_shardings`` gives each
    leaf under the mode ``shard_sources`` picks."""
    from crosscoder_tpu_torch.checkpoint.ckpt import leaf_key

    out: dict[str, tuple] = {}

    def record(kind, name, leaf):
        out[leaf_key(kind, name)] = _leaf_spec(kind, name, leaf, shard_sources)
        return leaf

    _map_state(state, record)
    return out


def shard_state(mesh: Mesh, state, shard_sources: bool = False):
    """This rank's shards (under the rules ``shard_sources`` picks) of a
    full TrainState that every rank built identically, every leaf in
    memory of its own (:func:`~.multihost.local_shard`; no communication)."""
    from crosscoder_tpu_torch.parallel.multihost import local_shard

    def shard(kind, name, leaf):
        sd = shard_dim(_leaf_spec(kind, name, leaf, shard_sources))
        if sd is None:
            return local_shard(leaf, None)
        dim, axis = sd
        return local_shard(leaf, (dim, mesh.size(axis), mesh.index(axis)))

    return _map_state(state, shard)


def gather_state(mesh: Mesh, state, shard_sources: bool = False):
    """The full TrainState on every rank from the ranks' shards (under
    the rules ``shard_sources`` picks; one all-gather a sharded leaf, in the
    same order on every rank)."""

    def gather(kind, name, leaf):
        sd = shard_dim(_leaf_spec(kind, name, leaf, shard_sources))
        if sd is None:
            return leaf
        dim, axis = sd
        return coll.all_gather_cat(leaf, dim, mesh.group(axis))

    return _map_state(state, gather)
