"""Rank worker for the port's multi-rank CPU tests (gloo), and the launcher
the tests call. Imports no JAX.

Run as: python tests/_torch_parallel_child.py <rank> <world> <port> <task.json>

The task's ``kind`` picks what a rank does; each rank writes what it
found to ``<out>/rank<r>.pt`` (``torch.save``):

- ``train``: for each named config, a fresh ``Trainer`` on the grid
  (``data`` × ``model``) for ``steps`` steps; per-step losses, step 0's
  active latents and the gathered params after the last step;
- ``quant``: ``quant_ar.quantized_pmean`` of this rank's gradient rows
  (``g [world, ...]``, ``ef [world, L]`` in the task's ``.npz``) for
  ``rounds`` rounds: the outputs, residuals and phase 1's q and scales;
- ``stop``: a SIGTERM on one rank stops every rank at the same step;
- ``guard``: ``Trainer.train`` with the loss guard over a source that NaNs
  one serve, the primary's checkpoint writes slowed by ``slow_write_s``:
  the resilience counters and the final step;
- ``coll``: the counted and the differentiable collectives on a small
  tensor;
- ``ckpt``: a ``Trainer`` saves after ``steps`` steps; then fresh
  trainers on the same grid restore (from ``views``: one checkpoint root
  a rank) and report the restored state and step;
- ``harvest``: the parallel harvest's cases (``tests/_torch_harvest_child.py``);
- ``mesh_rest``: the mesh's last refusals lifted (``tests/_torch_mesh_rest_child.py``);
- ``comm``: the collectives' bytes of one step a program (``tests/_torch_comm_child.py``);
- ``prefetch``: the trainer's prefetch on against off (``tests/_torch_prefetch_child.py``);
- ``fleet_mesh``: the fleet on a grid (``tests/_torch_fleet_mesh_child.py``);
- ``obs``: the telemetry plane's comm gauges on a grid (``tests/_torch_obs_child.py``);
- ``elastic``: the buffer's reshard across a survivor shrink
  (``tests/_torch_elastic_child.py``); such a task joins an elastic world
  (``multihost.elastic_initialize``, ``task["local"]`` ranks a host, each
  collective bound by ``task["timeout_s"]``, default 30 s);
- ``grow``: the elastic grow (``tests/_torch_grow_child.py``), in an
  elastic world too.
"""

from __future__ import annotations

import json
import os
import socket
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _server():
    """The process context the ranks start from: a fork server, a fresh
    interpreter with no threads that has imported torch once, so a rank is
    a fork of it (a few ms) rather than a fresh interpreter importing torch
    (seconds of CPU a rank). As with any fork server, a script that
    launches ranks guards its top level with ``if __name__ ==
    "__main__"``: each rank imports the main module."""
    import multiprocessing as mp
    from multiprocessing import forkserver

    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(["torch", "numpy"])
    # the server's environment, fixed when it starts, is every rank's: one
    # thread a rank
    saved = dict(os.environ)
    os.environ.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    try:
        forkserver.ensure_running()
    finally:
        os.environ.clear()
        os.environ.update(saved)
    return ctx


def _rank_entry(argv: list[str], log_path: str) -> None:
    """One rank, in a process forked from :func:`_server`: its output goes
    to ``log_path``, it runs from the repo root, then :func:`main`."""
    fd = os.open(log_path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    os.dup2(fd, 1)
    os.dup2(fd, 2)
    os.close(fd)
    os.chdir(ROOT)
    for d in (str(HERE), str(ROOT)):
        if d not in sys.path:
            sys.path.insert(0, d)
    sys.argv = [str(HERE / "_torch_parallel_child.py"), *argv]
    main()


def start_ranks(world: int, task: dict, tmp: Path):
    """Start ``task`` on ``world`` gloo ranks (one process each, one thread
    each, output to ``<tmp>/rank<r>.log``) and return at once; the caller
    may work while they run, then :func:`finish_ranks`."""
    tmp.mkdir(parents=True, exist_ok=True)
    task = dict(task, out=str(tmp))
    path = tmp / "task.json"
    path.write_text(json.dumps(task))
    port = free_port()
    ctx = _server()
    procs = []
    for r in range(world):
        p = ctx.Process(target=_rank_entry, args=(
            [str(r), str(world), str(port), str(path)], str(tmp / f"rank{r}.log")))
        p.start()
        procs.append(p)
    return procs, tmp


def finish_ranks(started, timeout: float = 240.0) -> list[dict]:
    """Every rank's results of a :func:`start_ranks` launch, rank order.
    Raises with the ranks' output when one fails or the time runs out."""
    import time

    import torch

    procs, tmp = started
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(timeout=max(0.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if any(p.exitcode for p in procs):
        logs = [tmp / f"rank{r}.log" for r in range(len(procs))]
        outs = [log.read_bytes().decode(errors="replace") if log.exists()
                else "(no log: the rank failed before it started)" for log in logs]
        raise RuntimeError("rank failed:\n" + "\n".join(
            f"--- rank {r} rc {p.exitcode}\n{o[-4000:]}" for r, (p, o) in
            enumerate(zip(procs, outs))))
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(len(procs))]


def run_ranks(world: int, task: dict, tmp: Path, timeout: float = 240.0) -> list[dict]:
    """Run ``task`` on ``world`` gloo ranks and return every rank's results
    (:func:`start_ranks`, then :func:`finish_ranks`)."""
    return finish_ranks(start_ranks(world, task, tmp), timeout)


def _cfg(task, name, **extra):
    from crosscoder_tpu_torch.config import CrossCoderConfig

    return CrossCoderConfig(**{**task["base"], **task["configs"][name], **extra})


def _train(task, rank):
    import torch

    from crosscoder_tpu_torch.data.synthetic import SyntheticActivationSource
    from crosscoder_tpu_torch.models import crosscoder as cc
    from crosscoder_tpu_torch.parallel import collectives as coll
    from crosscoder_tpu_torch.parallel import mesh as mesh_lib
    from crosscoder_tpu_torch.train.trainer import Trainer
    from crosscoder_tpu_torch.utils.dtypes import dtype_of

    out = {}
    for name in task["configs"]:
        cfg = _cfg(task, name, data_axis_size=task["data"], model_axis_size=task["model"])
        mesh = mesh_lib.mesh_from_cfg(cfg)
        state = None
        if task.get("state"):           # a full TrainState every rank starts from
            state = torch.load(task["state"][name], weights_only=False)
        tr = Trainer(cfg, SyntheticActivationSource(cfg), device="cpu", mesh=mesh, state=state)
        # step 0's active latents over the whole batch, before any update
        x = torch.from_numpy(SyntheticActivationSource(cfg).next())
        rows = x.shape[0] // mesh.data_size
        x = x[mesh.data_rank * rows:(mesh.data_rank + 1) * rows]
        dt = dtype_of(cfg.enc_dtype)
        with torch.no_grad():
            params = cc.cast_params(tr.state.params, dt)
            f = cc._activate(cc.pre_acts(params, x.to(dt)), cfg, params, mesh)
        f = coll.all_gather_cat(coll.all_gather_cat(f, 1, mesh.model_group), 0, mesh.data_group)
        active = (f > 0).numpy()
        steps = []
        for _ in range(task["steps"]):
            m = tr.step()
            steps.append({k: float(v) if not torch.is_tensor(v) or v.dim() == 0 else
                          v.numpy().tolist() for k, v in m.items()})
        full = mesh_lib.gather_state(mesh, tr.state)
        out[name] = {"steps": steps, "active": active,
                     "params": {k: v.float().numpy() for k, v in full.params.items()}}
    return out


def _quant(task, rank):
    import numpy as np
    import torch
    import torch.distributed as dist

    from crosscoder_tpu_torch.parallel import quant_ar

    group = dist.new_group(list(range(dist.get_world_size())))
    res = []
    with np.load(task["inputs"]) as z:
        leaves = sorted({k.split("/")[0] for k in z.files})
        for leaf in leaves:
            g_all = z[f"{leaf}/g"]
            ef = torch.from_numpy(z[f"{leaf}/ef"][rank:rank + 1].copy())
            outs = []
            for r in range(task["rounds"]):
                g = torch.from_numpy(g_all[r, rank].copy())
                out, ef, p1 = quant_ar.quantized_pmean(group, g, ef, task["block"])
                outs.append({"out": out.numpy(), "ef": ef.numpy(), "q": p1["q"].numpy(),
                             "scales": p1["scales"].numpy()})
            res.append((leaf, outs))
    return dict(res)


def _ckpt(task, rank):
    import torch

    from crosscoder_tpu_torch.checkpoint import Checkpointer
    from crosscoder_tpu_torch.data.synthetic import SyntheticActivationSource
    from crosscoder_tpu_torch.parallel import mesh as mesh_lib
    from crosscoder_tpu_torch.train.trainer import Trainer

    name = next(iter(task["configs"]))
    cfg = _cfg(task, name, data_axis_size=task["data"], model_axis_size=task["model"])
    res = {}
    if task.get("steps"):
        ck = Checkpointer(task["root"])
        tr = Trainer(cfg, SyntheticActivationSource(cfg), device="cpu", checkpointer=ck)
        for i in range(task["steps"]):
            tr.step()
            if i + 1 in task.get("save_at", []):
                tr.save(background=i % 2 == 0)
        tr.save()
        tr.close()
        full = mesh_lib.gather_state(tr.mesh, tr.state)
        res["saved"] = {k: v.float().numpy() for k, v in full.params.items()}
        res["saved_ef"] = {p: t.numpy() for p, t in (full.aux or {}).get("quant_ef", {}).items()}
        res["save_dir"] = None if ck.save_dir is None else str(ck.save_dir)
    for view in task.get("views", []):
        root = view[rank] if isinstance(view, list) else view
        rcfg = cfg
        if task.get("restore_grid"):
            d, m = task["restore_grid"]
            rcfg = cfg.replace(data_axis_size=d, model_axis_size=m)
        tr = Trainer(rcfg, SyntheticActivationSource(rcfg), device="cpu",
                     checkpointer=Checkpointer(root))
        meta = tr.restore()
        full = mesh_lib.gather_state(tr.mesh, tr.state)
        res.setdefault("restored", []).append({
            "step": int(meta["step"]), "save_version": int(meta["save_version"]),
            "params": {k: v.float().numpy() for k, v in full.params.items()},
            "aux": {k: (v.numpy() if torch.is_tensor(v) else
                        {p: t.numpy() for p, t in v.items()})
                    for k, v in (full.aux or {}).items()}})
        tr.close()
    return res


def _coll(task, rank):
    import torch
    import torch.distributed as dist

    from crosscoder_tpu_torch.parallel import collectives as coll

    group = dist.new_group(list(range(dist.get_world_size())))
    coll.reset_counts()
    w = torch.tensor([1.0, 2.0, 3.0])
    x = torch.full((3,), float(rank + 1), requires_grad=True)
    y = coll.sum_over(x, group)                  # replicated downstream
    (y * w).sum().backward()
    p = torch.ones(3, requires_grad=True)
    (coll.copy_to(p, group) * (rank + 1)).sum().backward()
    rows = torch.arange(dist.get_world_size() * 2).reshape(-1, 2) + 10 * rank
    return {"sum": y.detach(), "x_grad": x.grad, "p_grad": p.grad,
            "gather": coll.all_gather_cat(torch.tensor([[rank]]), 1, group),
            "to_all": coll.all_to_all(rows, group), "calls": dict(coll.calls)}


def _stop(task, rank):
    """``Trainer.train`` with a SIGTERM raised on rank 1 only, inside its
    serve ``task["signal_at"]``: the step every rank stops after."""
    import os
    import signal

    from crosscoder_tpu_torch.checkpoint import Checkpointer
    from crosscoder_tpu_torch.data.synthetic import SyntheticActivationSource
    from crosscoder_tpu_torch.train.trainer import Trainer

    cfg = _cfg(task, next(iter(task["configs"])), data_axis_size=task["data"],
               checkpoint_dir=task["root"])

    class Source(SyntheticActivationSource):
        def next(self):
            if rank == 1 and self.counter == task["signal_at"]:
                os.kill(os.getpid(), signal.SIGTERM)
            return super().next()

    tr = Trainer(cfg, Source(cfg), device="cpu", checkpointer=Checkpointer(task["root"]))
    tr.train()
    return {"step": tr.step_counter}


def _guard(task, rank):
    """The guard's rollback on a grid while the primary's background write
    is still in flight: every artifact the primary writes first sleeps
    ``task["slow_write_s"]``."""
    import time

    from crosscoder_tpu_torch.checkpoint import Checkpointer, ckpt
    from crosscoder_tpu_torch.data.synthetic import SyntheticActivationSource
    from crosscoder_tpu_torch.train.trainer import Trainer

    from _torch_mesh_rest_child import PoisonedSource

    if rank == 0:
        savez = ckpt._atomic_savez

        def slow_savez(path, arrays):
            time.sleep(task["slow_write_s"])
            return savez(path, arrays)

        ckpt._atomic_savez = slow_savez
    cfg = _cfg(task, next(iter(task["configs"])), data_axis_size=task["data"],
               model_axis_size=task["model"], checkpoint_dir=task["root"])
    tr = Trainer(cfg, PoisonedSource(SyntheticActivationSource(cfg), task["nan_serves"]),
                 device="cpu", checkpointer=Checkpointer(cfg=cfg))
    tr.train()
    return {"step": tr.step_counter, "resilience": tr.resilience.snapshot()}


def _harvest(task, rank):
    import _torch_harvest_child

    return _torch_harvest_child.run(task, rank)


def _mesh_rest(task, rank):
    import _torch_mesh_rest_child

    return _torch_mesh_rest_child.run(task, rank)


def _comm(task, rank):
    import _torch_comm_child

    return _torch_comm_child.run(task, rank)


def _prefetch(task, rank):
    import _torch_prefetch_child

    return _torch_prefetch_child.run(task, rank)


def _fleet_mesh(task, rank):
    import _torch_fleet_mesh_child

    return _torch_fleet_mesh_child.run(task, rank)


def _obs(task, rank):
    import _torch_obs_child

    return _torch_obs_child.run(task, rank)


def _elastic(task, rank):
    import _torch_elastic_child

    return _torch_elastic_child.run(task, rank)


def _grow(task, rank):
    import _torch_grow_child

    return _torch_grow_child.run(task, rank)


def main() -> None:
    rank, world, port, path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    import torch

    torch.set_num_threads(1)
    from crosscoder_tpu_torch.parallel import multihost

    task = json.loads(Path(path).read_text())
    if task["kind"] in ("elastic", "grow"):
        multihost.elastic_initialize(f"127.0.0.1:{port}", world, rank, device="cpu",
                                     timeout_s=task.get("timeout_s", 30.0),
                                     local_world_size=task["local"])
    else:
        multihost.initialize(device="cpu", init_method=f"tcp://127.0.0.1:{port}",
                             world_size=world, rank=rank)
    try:
        res = {"train": _train, "quant": _quant, "ckpt": _ckpt,
               "coll": _coll, "stop": _stop, "guard": _guard, "harvest": _harvest,
               "mesh_rest": _mesh_rest, "comm": _comm, "prefetch": _prefetch,
               "fleet_mesh": _fleet_mesh, "obs": _obs,
               "elastic": _elastic, "grow": _grow}[task["kind"]](task, rank)
        torch.save(res, Path(task["out"]) / f"rank{rank}.pt")
    finally:
        multihost.shutdown()


if __name__ == "__main__":
    main()
