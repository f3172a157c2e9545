"""The elastic grow on real gloo ranks (``kind: grow`` of
``tests/_torch_parallel_child.py``; such a task joins an elastic world,
``task["local"]`` ranks a host). Imports no JAX. ``task["case"]``:

- ``agree``: every rank is a survivor of one host (the world is the
  coordinator host's ranks); rank 0 announces a candidate on the board
  between two polls, and each rank records its ``grow_ready`` answers and
  stable sets; then ``grow`` with no joiner coming: each rank records the
  admit record, the abort counter and the epoch it goes on narrow at;
- ``respec``: two ranks, one a host; the wide 2 × 1 grid (``quant_grads``)
  steps and saves, rank 1 leaves, rank 0 shrinks to 1 × 1, restores, steps
  and saves, then rank 1 rejoins through ``grow_to`` and both restore the
  narrow save on the wide grid and step once;
- ``stream``: two ranks, one a host, the mesh store on 2 × 1 serves 3
  batches; rank 1 leaves, rank 0 reshards onto 1 × 1 and serves 2; both
  meet again at 2 × 1 (rank 0 reshards with ``refill=True``, rank 1's store
  takes rank 0's position), and serve beside a fresh wide store restored
  from the same position;
- ``fleet``: two ranks (the fleet's re-mesh changes the grid, not the
  ranks); the fleet on ``task["from"]`` saves, steps on,
  re-meshes onto ``task["to"]`` and steps; a fresh fleet on ``task["to"]``
  restores the same save and steps.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np

BASE = dict(d_in=32, dict_size=64, n_models=2, batch_size=16, num_tokens=16 * 100,
            enc_dtype="fp32", log_backend="null", prefetch=False)


def run(task, rank):
    return {"agree": _agree, "respec": _respec, "stream": _stream,
            "fleet": _fleet}[task["case"]](task, rank)


def _agree(task, rank):
    from crosscoder_tpu_torch.config import CrossCoderConfig
    from crosscoder_tpu_torch.parallel import multihost
    from crosscoder_tpu_torch.resilience import elastic as el
    from crosscoder_tpu_torch.utils.logging import ResilienceCounters

    root = Path(task["root"])
    cfg = CrossCoderConfig(**BASE, elastic="on", elastic_grow="on", checkpoint_dir=str(root),
                           elastic_grace_s=3.0, elastic_dwell_steps=0,
                           elastic_grow_debounce=2, stop_poll_every=1)
    counters = ResilienceCounters()
    ctl = el.ElasticController(cfg, counters=counters)
    board = el.RendezvousBoard(root / "elastic_board")
    ready, stable = [], []
    for step in range(3):
        if rank == 0:       # the candidate's beat, between the coordinator's polls
            board.announce("host1", task["local"], seq=step)
        ready.append(ctl.grow_ready(step))
        stable.append([c["id"] for c in ctl._stable_candidates])
        multihost.probe_liveness(f"a{step}", timeout_s=30.0)     # the loop's step
    mesh, admit = ctl.grow(2, save_version=0, version_dir=str(root / "version_0"),
                           save_step=2)
    return {"ready": ready, "stable": stable, "admit": ctl.last_admit, "grown": admit,
            "counters": counters.snapshot(), "epoch": multihost.membership().epoch,
            "world": multihost.world_size(), "grid": (mesh.data_size, mesh.model_size)}


def _ef_widths(state):
    """The data widths of a whole state's ``quant_ef`` residuals (None: none)."""
    ef = (state.aux or {}).get("quant_ef")
    return None if ef is None else sorted({int(v.shape[0]) for v in ef.values()})


def _rejoin(task, rank, epoch):
    """Rank ``rank`` (off the coordinator host) leaves the world, then comes
    back into it at ``epoch`` as a returned joiner, on the same store."""
    from crosscoder_tpu_torch.parallel import multihost

    m = multihost.membership()
    multihost.shutdown()
    return multihost.grow_to(m.coordinator_address, m.num_processes, rank, epoch,
                             device="cpu", backend="gloo", timeout_s=30.0,
                             local_world_size=task["local"])


def _respec(task, rank):
    from crosscoder_tpu_torch.checkpoint import Checkpointer
    from crosscoder_tpu_torch.config import CrossCoderConfig
    from crosscoder_tpu_torch.parallel import mesh as mesh_lib
    from crosscoder_tpu_torch.parallel import multihost
    from crosscoder_tpu_torch.train.trainer import Trainer

    root = task["root"]
    cfg = CrossCoderConfig(**BASE, checkpoint_dir=root, quant_grads=True, quant_block=32)
    out = {}
    a = Trainer(cfg, device="cpu", mesh=mesh_lib.make_mesh(2, 1),
                checkpointer=Checkpointer(root))
    out["wide_ef"] = _ef_widths(mesh_lib.gather_state(a.mesh, a.state))
    for _ in range(2):
        a.step()
    a.save()
    a.close()
    del a
    if rank == 0:
        multihost.shrink_to_local()
        b = Trainer(cfg, device="cpu", mesh=mesh_lib.make_mesh(1, 1),
                    checkpointer=Checkpointer(root))
        out["narrow_step"] = int(b.restore()["step"])
        out["narrow_ef"] = _ef_widths(b.state)
        out["narrow_loss"] = float(b.step()["loss"])
        b.save()
        out["narrow_params"] = {k: v.clone() for k, v in b.state.params.items()}
        b.close()
        del b
        multihost.grow_to(multihost.membership().coordinator_address, 2, 0, 2)
    else:
        _rejoin(task, rank, 2)
    out["epoch"] = multihost.membership().epoch
    mesh = mesh_lib.make_mesh(2, 1)
    c = Trainer(cfg, device="cpu", mesh=mesh, checkpointer=Checkpointer(root))
    meta = c.restore()
    out["wide_step"] = int(meta["step"])
    full = mesh_lib.gather_state(mesh, c.state)
    out["regrown_ef"] = _ef_widths(full)
    out["regrown_ef_zero"] = all(bool((v == 0).all())
                                 for v in (full.aux or {}).get("quant_ef", {}).values())
    # the step below writes the params in place
    out["regrown_params"] = {k: v.clone() for k, v in full.params.items()}
    out["regrown_loss"] = float(c.step()["loss"])
    out["save"] = int(meta["save_version"])
    c.close()
    return out


def _stream(task, rank):
    import torch

    from crosscoder_tpu_torch.config import CrossCoderConfig
    from crosscoder_tpu_torch.data import buffer as buf
    from crosscoder_tpu_torch.models import lm
    from crosscoder_tpu_torch.parallel import mesh as mesh_lib
    from crosscoder_tpu_torch.parallel import multihost

    lm_cfg = lm.LMConfig.tiny()
    params = [lm.init_params(lm_cfg, seed=s, device="cpu") for s in (0, 1)]
    tokens = np.random.default_rng(11).integers(0, 257, size=(256, 17), dtype=np.int64)
    cfg = CrossCoderConfig(batch_size=32, buffer_mult=32, seq_len=17, d_in=32, n_models=2,
                           model_batch_size=4, norm_calib_batches=2, seed=3,
                           hook_point="blocks.2.hook_resid_pre", buffer_device="hbm",
                           data_axis_size=2)
    b = buf.make_buffer(cfg, lm_cfg, params, tokens, mesh=mesh_lib.make_mesh(2, 1),
                        device="cpu")
    for _ in range(3):
        b.next_raw()
    b.prepare_reshard()
    snap_file = Path(task["root"]) / "snap.pt"
    out = {"class": type(b).__name__}
    if rank == 0:
        multihost.shrink_to_local()
        b.reshard(mesh_lib.make_mesh(1, 1), refill=True)      # the shrink leg...
        for _ in range(2):
            b.next_raw()
        snap = b.state_dict()
        torch.save(snap, snap_file)
        b.prepare_reshard()
        multihost.grow_to(multihost.membership().coordinator_address, 2, 0, 2)
        wide = mesh_lib.make_mesh(2, 1)
        b.reshard(wide, refill=True)                           # ...and the grow back
    else:
        _rejoin(task, rank, 2)
        wide = mesh_lib.make_mesh(2, 1)
        snap = torch.load(snap_file, weights_only=False)
        b.reshard(wide, refill=False)
        b.load_state_dict(snap)
    out["epoch"] = multihost.membership().epoch
    ref = buf.make_buffer(cfg, lm_cfg, params, tokens, mesh=wide, device="cpu", lazy=True)
    ref.load_state_dict(snap)
    got, want = [], []
    for _ in range(6):
        got.append(b.next_raw().view(torch.int16).numpy())
        want.append(ref.next_raw().view(torch.int16).numpy())
    out.update(got=np.stack(got), want=np.stack(want), ref_class=type(ref).__name__)
    return out


def _fleet(task, rank):
    from crosscoder_tpu_torch.config import CrossCoderConfig
    from crosscoder_tpu_torch.parallel import mesh as mesh_lib
    from crosscoder_tpu_torch.train.fleet import FleetScheduler

    spec = task["spec"]
    (d0, m0), (d1, m1) = task["from"], task["to"]

    def fleet(d, m, mesh):
        cfg = CrossCoderConfig(**{**BASE, "fleet": "on", "fleet_tenants": spec,
                                  "checkpoint_dir": task["root"], "data_axis_size": d,
                                  "model_axis_size": m})
        return FleetScheduler(cfg, device="cpu", mesh=mesh)

    def rounds(fl, n):
        out: dict[str, list[str]] = {}
        for _ in range(n):
            for name, md in fl.step_all().items():
                out.setdefault(name, []).append(float(md["loss"]).hex())
        return out

    fl = fleet(d0, m0, mesh_lib.make_mesh(d0, m0))
    rounds(fl, 3)
    fl.save_all()
    rounds(fl, 2)               # the live state moves past the save
    target = mesh_lib.make_mesh(d1, m1)
    t0 = time.perf_counter()
    fl.remesh(target)
    remesh_s = time.perf_counter() - t0
    after = rounds(fl, 3)
    grid = (fl.mesh.data_size, fl.mesh.model_size)
    got = {n: mesh_lib.gather_state(target, fl.tenant_state(n)).params for n in fl.active()}
    fresh = fleet(d1, m1, target)
    restored = fresh.restore_all()
    want_losses = rounds(fresh, 3)
    want = {n: mesh_lib.gather_state(target, fresh.tenant_state(n)).params
            for n in fresh.active()}
    return {"after": after, "fresh": want_losses, "restored": restored, "grid": grid,
            "params": got, "fresh_params": want, "remesh_s": remesh_s,
            "stream": [fl.buffer.counter, fresh.buffer.counter],
            "cohorts": [[t.name for t in co.members] for co in fl._cohorts],
            "buckets": [b.tenant.name for b in fl._buckets]}
