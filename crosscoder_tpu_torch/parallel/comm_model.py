"""Per-step collective bytes of the port's programs, and a scale-out model,
ported from :mod:`crosscoder_tpu.parallel.comm_model`.

One card holds one NCCL rank, so multi-card throughput is not measured;
what decides whether n cards deliver about n× is the bytes each step
moves between them. The JAX package reads them out of compiled HLO
(``collective_bytes``, ``_shape_bytes``). PyTorch has no HLO, so those two
have no counterpart here: every collective of the port goes through
:mod:`crosscoder_tpu_torch.parallel.collectives`, which counts the bytes
each delivers by op (:data:`~crosscoder_tpu_torch.parallel.collectives.bytes`),
and those counts take the parser's place.

:func:`profile_width` runs one step of rank 0's program at full shape
under a process group of n ranks that moves nothing (PyTorch's fake
backend), so one process counts a width-n program: the step's shapes do
not depend on the data (TopK's k, BatchTopK's one threshold, AuxK's
``k_aux`` and the sparse backward's pairs are fixed). Its results use
JAX's op names (``all-reduce``, ``all-gather``, ``reduce-scatter``,
``all-to-all``, ``collective-permute`` for the ring's hop, and ``count``),
so :func:`wire_bytes` and :func:`predict` are JAX's arithmetic over
either package's profiles.
"""

from __future__ import annotations

import dataclasses
import sys
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from crosscoder_tpu_torch.parallel import collectives as coll

# the port's op keys → JAX's HLO op names
_OPS = {"all_reduce": "all-reduce", "all_gather": "all-gather",
        "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
        "ring_shift": "collective-permute"}


@dataclass
class CommProfile:
    """Collective bytes per executed step of one program at mesh width n."""

    program: str
    n_devices: int
    model_axis: int
    bytes_by_op: dict[str, int] = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(v for k, v in self.bytes_by_op.items() if k != "count")


# Per-device wire bytes per output byte under the ring algorithms: an
# all-reduce is a reduce-scatter and an all-gather (2·(n−1)/n passes of
# the tensor), the one-phase collectives move (n−1)/n of their output, a
# permute its payload (JAX's table).
_WIRE_FACTORS = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}


def wire_bytes(profile: CommProfile, axis_size: int | None = None) -> float:
    """Modeled per-device wire bytes per step: output bytes × the ring
    factor × (n−1)/n. ``axis_size`` is the width of the group the
    collectives run over, by default the profile's ``data`` axis (right
    for the DP gradient sum); a width of 1 moves nothing."""
    n = axis_size if axis_size is not None else (
        profile.n_devices // max(1, profile.model_axis))
    if n <= 1:
        return 0.0
    ring = (n - 1) / n
    return sum(v * _WIRE_FACTORS[k] * ring
               for k, v in profile.bytes_by_op.items() if k in _WIRE_FACTORS)


def counted_profile(program: str, n_devices: int, model_axis: int = 1) -> CommProfile:
    """The collectives counted since the last
    :func:`~crosscoder_tpu_torch.parallel.collectives.reset_counts`, as a
    profile under JAX's op names (``count``: the calls that moved bytes)."""
    by_op = {jax_op: int(coll.bytes[op]) for op, jax_op in _OPS.items()}
    by_op["count"] = int(sum(coll.wire_calls.values()))
    return CommProfile(program, n_devices, model_axis, by_op)


# ---------------------------------------------------------------------------
# one rank's program at width n


def program_config(program: str, n_devices: int, model_axis: int = 1,
                   dict_size: int = 2 ** 15, d_in: int = 2304, batch_size: int = 4096):
    """The config of a train program (``"train_dp"``, ``"train_dp_quant"``,
    ``"train_dp_tp"``) at width ``n_devices`` under JAX's base config: two
    models, bf16 encoder and masters (prefetch off: one thread)."""
    from crosscoder_tpu_torch.config import CrossCoderConfig

    if program not in ("train_dp", "train_dp_quant", "train_dp_tp"):
        raise ValueError(f"not a train program: {program!r}")
    return CrossCoderConfig(
        d_in=d_in, dict_size=dict_size, n_models=2, batch_size=batch_size, enc_dtype="bf16",
        master_dtype="bf16", log_backend="null", prefetch=False,
        quant_grads=program == "train_dp_quant", data_axis_size=n_devices // model_axis,
        model_axis_size=model_axis)


def _train_step(cfg, mesh, device) -> None:
    """One bare step of the mesh Trainer under ``cfg`` (synthetic
    batches), its collectives counted."""
    from crosscoder_tpu_torch.train.trainer import Trainer

    tr = Trainer(cfg, device=device, mesh=mesh)
    try:
        coll.reset_counts()
        tr.step(full_metrics=False)
        if tr.device.type == "cuda":
            torch.cuda.synchronize(tr.device)
    finally:
        tr.close()


@torch.no_grad()
def _harvest(hook: str, batch: int, seq_len: int, lm_cfg, mesh, device,
             seq_parallel: bool) -> None:
    """One harvest forward of a ``[batch, seq_len]`` chunk to the hook
    point, its collectives counted: each rank's rows of the chunk (DP), or
    the whole chunk with the sequence split over ``data`` (SP, the ring)."""
    import numpy as np

    from crosscoder_tpu_torch.models import lm

    params = lm.init_params(lm_cfg, seed=0, device=device)
    tokens = np.random.default_rng(0).integers(0, lm_cfg.vocab_size, size=(batch, seq_len))
    coll.reset_counts()
    if seq_parallel:
        lm.forward_seq_parallel(params, tokens, lm_cfg, mesh, capture=(hook,),
                                return_logits=False)
    else:
        rows = batch // mesh.data_size
        lm.forward(params, tokens[mesh.data_rank * rows:(mesh.data_rank + 1) * rows], lm_cfg,
                   capture=(hook,), return_logits=False)


def _own_input(op: str, group, sent, outs) -> None:
    """:data:`collectives.fill` under the fake group, which writes no
    output: each is filled from this rank's own input (an all-gather
    repeats it, a reduce-scatter keeps this rank's rows, an all-to-all and
    a ring hop return what was sent, an all-reduce leaves it as it was), so
    the program reads values of the right range. Only shapes and bytes
    mean anything."""
    if op == "all_gather":
        (out,) = outs
        out.copy_(sent.repeat(out.shape[0] // sent.shape[0], *([1] * (sent.dim() - 1))))
    elif op == "reduce_scatter":
        (out,) = outs
        r = dist.get_rank(group) * out.shape[0]
        out.copy_(sent[r:r + out.shape[0]])
    elif op == "all_to_all":
        outs[0].copy_(sent)
    elif op == "ring_shift":
        for r, s in zip(outs, sent):
            r.copy_(s)


def profile_width(n_devices: int, model_axis: int = 1, dict_size: int = 2 ** 15,
                  d_in: int = 2304, batch_size: int = 4096,
                  programs=("train", "train_tp", "harvest", "sp_harvest"), lm_cfg=None,
                  seq_len: int = 1024, device=None) -> list[CommProfile]:
    """The collectives of the production programs at width ``n_devices``,
    counted on rank 0 of a fake group of that many ranks: ``train_dp``
    (``programs`` key ``"train"``), ``train_dp_quant`` (``"train_quant"``,
    the int8 exchange, n > 1), ``train_dp_tp`` (``"train_tp"``,
    ``model_axis`` > 1 dividing n), ``harvest_dp`` and ``harvest_sp``
    (``"harvest"``, ``"sp_harvest"``, n > 1; the LM defaults to
    Gemma-2-2B cut to 14 layers). JAX's base config: two models, bf16
    encoder and masters. Runs at full shape on ``device`` (``cuda`` unless
    named). A process holds one default group, so this raises
    :class:`RuntimeError` in a process that has joined one; the fake group
    is gone when it returns."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from crosscoder_tpu_torch.models import lm
    from crosscoder_tpu_torch.parallel import mesh as mesh_lib
    from crosscoder_tpu_torch.utils.device import resolve_device

    if dist.is_initialized():
        raise RuntimeError("profile_width starts a fake process group of its own; run it in "
                           "a process that has joined none")
    device = resolve_device(device)
    shape = dict(dict_size=dict_size, d_in=d_in, batch_size=batch_size)
    out: list[CommProfile] = []
    excepthook = sys.excepthook            # the group's start wraps it
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n_devices)
    coll.fill = _own_input
    try:
        def prof(name, ma, run):
            mesh = mesh_lib.make_mesh(n_devices // ma, ma)
            run(mesh)
            out.append(counted_profile(name, n_devices, ma))

        def train(name, ma=1):
            cfg = program_config(name, n_devices, ma, **shape)
            prof(name, ma, lambda mesh: _train_step(cfg, mesh, device))

        if "train" in programs:
            train("train_dp")
        if "train_quant" in programs and n_devices > 1:
            train("train_dp_quant")
        if "train_tp" in programs and model_axis > 1 and n_devices % model_axis == 0:
            train("train_dp_tp", model_axis)
        if "harvest" in programs or "sp_harvest" in programs:
            if lm_cfg is None:
                lm_cfg = dataclasses.replace(lm.LMConfig.gemma2_2b(), n_layers=14)
            hook_layer = min(lm_cfg.n_layers - 1, 14)
            hook = f"blocks.{hook_layer}.hook_resid_pre"
            if "harvest" in programs:
                prof("harvest_dp", 1, lambda mesh: _harvest(
                    hook, max(4, n_devices), seq_len, lm_cfg, mesh, device, False))
            if "sp_harvest" in programs and n_devices > 1:
                prof("harvest_sp", 1, lambda mesh: _harvest(
                    hook, n_devices, seq_len, lm_cfg, mesh, device, True))
    finally:
        coll.fill = None
        dist.destroy_process_group()
        sys.excepthook = excepthook
        coll.reset_counts()
    return out


# ---------------------------------------------------------------------------
# the scale-out prediction

# The H100 SXM5's published NVLink rate: 900 GB/s in both directions
# together, 450 GB/s each way. A part's published figure, not a
# measurement: one card has no link to measure. It takes the place of
# JAX's v5e ``ICI_GBPS`` (100). As JAX's, the model assumes no overlap of
# the collectives with compute.
NVLINK_GBPS = 450.0


def predict(step_ms_1chip: float, profile: CommProfile,
            link_gbps: float = NVLINK_GBPS) -> dict:
    """Predicted per-card step time at width n: the measured one-card step
    (per-card work is constant under DP, the batch growing with n) plus
    the profile's bytes over the link, serialized (JAX's formula)."""
    comm_ms = profile.total_bytes / (link_gbps * 1e9) * 1e3
    step_n = step_ms_1chip + comm_ms
    return {
        "program": profile.program,
        "n_devices": profile.n_devices,
        "comm_bytes": profile.total_bytes,
        "comm_ms_no_overlap": round(comm_ms, 3),
        "step_ms_predicted": round(step_n, 2),
        "per_chip_efficiency": round(step_ms_1chip / step_n, 4),
    }
