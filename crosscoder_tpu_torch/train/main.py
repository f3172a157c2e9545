"""Training entry point, ported from :mod:`crosscoder_tpu.train.main`
(the reference's ``train.py:main``):

    python -m crosscoder_tpu_torch.train.main --data-source synthetic \\
        --num-tokens 8192 --batch-size 512 --dict-size 4096 --d-in 256 ...

Config from the command line (every field a flag,
:meth:`CrossCoderConfig.from_cli`), the activation source
(:func:`build_buffer`), the single-device :class:`Trainer` with its
:class:`MetricsLogger` and a :class:`Checkpointer` over
``cfg.checkpoint_dir``. ``--resume true`` continues from the newest
verified save there (the buffer is built lazily and restored).

On several ranks (``torchrun --nproc-per-node N -m
crosscoder_tpu_torch.train.main ...``) each rank joins the process group
first (:func:`crosscoder_tpu_torch.parallel.multihost.initialize`: NCCL
on ``cuda:LOCAL_RANK``, gloo with ``--device cpu``), builds the
``data`` × ``model`` grid from ``--data-axis-size``/``--model-axis-size``
and trains its shards; only the primary rank logs and writes
checkpoints. ``--device`` names the device (default ``cuda:LOCAL_RANK``).
The buffer and the trainer share that grid: with ``--buffer-device hbm``
and a ``data`` axis wider than 1 the replay store is sharded over it;
``--seq-shards N`` harvests the sequence split over ``data`` (ring
attention); ``--shard-lm true`` loads each model tensor-parallel over
``model`` (``lm.from_hf(..., tp=mesh)``: this rank's slices only), every
rank reading the same local token cache.

``--fleet on --fleet-tenants "a:seed=1;b:seed=2,l1_coeff=0.01;w:dict_size=8192"``
trains N tenants off the one source instead
(:class:`crosscoder_tpu_torch.train.fleet.FleetScheduler`), each saving
under ``<checkpoint_dir>/tenants/<name>/`` and logging under
``tenant/<name>/…``; ``--resume true`` restores every tenant and the
stream (:meth:`FleetScheduler.restore_all`). On several ranks the fleet
trains on the same grid, each tenant on this rank's shards.

``--data-source gemma`` composes the Gemma-2 harvest: the models of
``--model-names`` loaded from local HF checkpoint directories
(:func:`crosscoder_tpu_torch.models.lm.from_hf`; the first one's config
is the pair's architecture), the local token cache, :func:`make_buffer`
and ``d_in`` from the model. A caller holding LM params (random init,
:mod:`crosscoder_tpu_torch.convert`) passes them to :func:`build_buffer`
instead.

Fault injection (``--chaos SPEC`` or the ``CROSSCODER_CHAOS`` variable,
:class:`crosscoder_tpu_torch.resilience.Chaos`) goes to the buffer, the
Checkpointer and the Trainer; ``--harvest-timeout-s``, ``--obs on``,
``--obs-dir``, ``--profile-steps`` and ``--profile-dir`` reach the Trainer
through the config. ``--tuned TUNED.json`` applies a pinned artifact's
knobs (:mod:`crosscoder_tpu_torch.tune`) under the explicit flags, and the
run says which artifact pinned them.
"""

from __future__ import annotations

import argparse
import sys
from typing import Any, Sequence

from crosscoder_tpu_torch.checkpoint import Checkpointer
from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.train.trainer import Trainer
from crosscoder_tpu_torch.utils.logging import MetricsLogger


def build_buffer(cfg: CrossCoderConfig, device=None, model_params: Sequence[Any] | None = None,
                 lm_cfg: Any | None = None, mesh=None, chaos: Any | None = None
                 ) -> tuple[Any, CrossCoderConfig]:
    """The activation source for ``cfg.data_source`` and ``cfg`` with
    ``d_in`` set from the harvested model. ``model_params``: one LM param
    dict per model, on ``device``; without them the gemma source loads
    each model name with ``lm.from_hf`` (a local directory, else
    :class:`ValueError`), tensor-parallel over ``mesh``'s ``model`` axis
    under ``cfg.shard_lm``. ``lm_cfg``: their architecture (default: the
    named Gemma-2 config with ``model_params``, the first checkpoint's own
    config when loading). ``mesh``: the rank grid the buffer shards over.
    ``chaos``: the harvest's fault plan (the replay buffer's only)."""
    if cfg.data_source == "synthetic":
        from crosscoder_tpu_torch.data.synthetic import SyntheticActivationSource

        return SyntheticActivationSource(cfg), cfg
    from crosscoder_tpu_torch.data.buffer import make_buffer
    from crosscoder_tpu_torch.data.tokens import load_pile_lmsys_mixed_tokens
    from crosscoder_tpu_torch.models import lm

    names = cfg.model_names or (f"google/{cfg.model_name}", f"google/{cfg.model_name}-it")
    if len(names) != cfg.n_models:
        raise ValueError(f"{len(names)} model names for n_models={cfg.n_models}")
    if model_params is None:
        if cfg.shard_lm and mesh is None:
            raise ValueError("shard_lm loads over the rank grid: pass mesh=")
        tp = mesh if cfg.shard_lm else None
        model_params = []
        for name in names:
            params, lm_cfg = lm.from_hf(name, lm_cfg, device=device, tp=tp)
            model_params.append(params)
    lm_cfg = lm_cfg or lm.config_for(names[0])
    cfg = cfg.replace(d_in=lm_cfg.d_model)
    tokens = load_pile_lmsys_mixed_tokens(cfg)
    return make_buffer(cfg, lm_cfg, model_params, tokens, mesh=mesh, device=device,
                       lazy=cfg.resume, chaos=chaos), cfg


def main(argv: list[str] | None = None, device=None) -> Any:
    """Train from ``argv`` (default: the process's arguments; ``--device``
    there, else ``device``); returns the :class:`Trainer`, or the
    :class:`~crosscoder_tpu_torch.train.fleet.FleetScheduler` under
    ``--fleet on``. Runs on ``cuda`` (``cuda:LOCAL_RANK`` under torchrun)
    unless a device is named."""
    import torch.distributed as dist

    from crosscoder_tpu_torch.parallel import multihost

    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default=None)
    known, rest = pre.parse_known_args(sys.argv[1:] if argv is None else argv)
    device = multihost.local_device(known.device or device)
    joined_here = not dist.is_initialized()
    distributed = multihost.initialize(device)
    cfg = CrossCoderConfig.from_cli(rest)
    if cfg.tuned:
        # from_cli applied the artifact's knobs; say which artifact pinned them
        print(f"[crosscoder_tpu_torch] tuned: running with pinned artifact {cfg.tuned}",
              file=sys.stderr, flush=True)
    if distributed:
        print(f"[crosscoder_tpu_torch] multihost: {multihost.process_info()}", file=sys.stderr,
              flush=True)
    mesh = None
    if dist.is_initialized() or cfg.model_axis_size > 1 or cfg.data_axis_size > 1:
        from crosscoder_tpu_torch.parallel import mesh as mesh_lib

        mesh = mesh_lib.mesh_from_cfg(cfg)      # one grid for the buffer and the trainer
    # None unless a spec is set: every hook site stays one is-None check
    from crosscoder_tpu_torch.resilience.chaos import Chaos

    chaos = Chaos.from_cfg_env(cfg)
    if chaos is not None:
        print(f"[crosscoder_tpu_torch] CHAOS ENABLED: {chaos.render()!r}", file=sys.stderr,
              flush=True)
    buffer, cfg = build_buffer(cfg, device=device, mesh=mesh, chaos=chaos)
    if cfg.fleet == "on":
        return _run_fleet(cfg, buffer, device, mesh, joined_here)
    trainer = Trainer(cfg, buffer, logger=MetricsLogger(cfg) if multihost.is_primary() else None,
                      device=device, checkpointer=Checkpointer(cfg=cfg, chaos=chaos), mesh=mesh,
                      chaos=chaos)
    try:
        trainer.train()
    finally:
        trainer.close()
        if joined_here:
            multihost.shutdown()
    return trainer


def _run_fleet(cfg: CrossCoderConfig, buffer: Any, device, mesh, joined_here: bool) -> Any:
    """The fleet branch of :func:`main`: every tenant off ``buffer``, each
    checkpointed under ``<checkpoint_dir>/tenants/<name>/``."""
    from crosscoder_tpu_torch.obs.registry import MetricsRegistry
    from crosscoder_tpu_torch.parallel import multihost
    from crosscoder_tpu_torch.train.fleet import FleetScheduler

    fleet = None
    try:
        fleet = FleetScheduler(cfg, buffer, registry=MetricsRegistry(), device=device, mesh=mesh,
                               logger=MetricsLogger(cfg) if multihost.is_primary() else None)
        if cfg.resume:
            print(f"[crosscoder_tpu_torch] fleet resumed: {fleet.restore_all()}",
                  file=sys.stderr, flush=True)
        fleet.run()
    finally:
        if fleet is not None:
            fleet.quiesce()
            if fleet.logger is not None:
                fleet.logger.close()
        if hasattr(buffer, "close"):
            buffer.close()
        if joined_here:
            multihost.shutdown()
    return fleet


if __name__ == "__main__":
    main()
