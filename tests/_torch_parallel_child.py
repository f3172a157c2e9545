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
- ``coll``: the counted and the differentiable collectives on a small
  tensor;
- ``ckpt``: a ``Trainer`` saves after ``steps`` steps; then fresh
  trainers on the same grid restore (from ``views``: one checkpoint root
  a rank) and report the restored state and step.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(world: int, task: dict, tmp: Path, timeout: float = 240.0) -> list[dict]:
    """Run ``task`` on ``world`` gloo ranks (one process each, one thread
    each); returns every rank's results, rank order. Raises with the
    ranks' output when one fails or the time runs out."""
    import torch

    tmp.mkdir(parents=True, exist_ok=True)
    task = dict(task, out=str(tmp))
    path = tmp / "task.json"
    path.write_text(json.dumps(task))
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, str(HERE / "_torch_parallel_child.py"), str(r),
                               str(world), str(port), str(path)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, cwd=ROOT)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        raise RuntimeError("rank failed:\n" + "\n".join(
            f"--- rank {r} rc {p.returncode}\n{o[-4000:]}" for r, (p, o) in
            enumerate(zip(procs, outs))))
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(world)]


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


def main() -> None:
    rank, world, port, path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    import torch

    torch.set_num_threads(1)
    from crosscoder_tpu_torch.parallel import multihost

    task = json.loads(Path(path).read_text())
    multihost.initialize(device="cpu", init_method=f"tcp://127.0.0.1:{port}",
                         world_size=world, rank=rank)
    try:
        res = {"train": _train, "quant": _quant, "ckpt": _ckpt,
               "coll": _coll, "stop": _stop}[task["kind"]](task, rank)
        torch.save(res, Path(task["out"]) / f"rank{rank}.pt")
    finally:
        multihost.shutdown()


if __name__ == "__main__":
    main()
