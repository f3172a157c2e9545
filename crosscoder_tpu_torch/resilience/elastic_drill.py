"""Elasticity drills, ported from :mod:`crosscoder_tpu.resilience.elastic_drill`
(the preempt and stability drills; the autoscale drill waits for scale-up).

- **preempt** (default): :func:`run_drill` spawns ``world`` ranks (gloo;
  ``local`` ranks a host, host-major, so the coordinator host holds ranks
  ``[0, local)``) on a ``data`` × ``model`` grid, trains with periodic
  saves, and has chaos kill every rank off the coordinator host abruptly
  (``die@N``: ``os._exit``, no notice) mid-run. The coordinator host's
  ranks must detect the loss, shrink to a ``1 × model`` world (the TP width
  kept), restore the newest verified save and finish the run. Then
  ``local`` CLEAN ranks restore the exact save the survivors used; the
  survivors' losses after the re-mesh must equal the clean restart's, bit
  for bit.
- **stability**: probe-path chaos only on rank 1 (``flaky@S:p``, skipped
  barriers; ``slow@S:ms``, a straggler), both below the hysteresis
  threshold: the pair must finish with ZERO remeshes while the counters
  show the faults fired.

Every rank runs on the one card unless the caller names the CPU
(``device="cpu"``, ``--device cpu``); with neither and no card the drill
raises. The ranks are gloo ranks either way (on the card they share it,
and gloo stages each collective through host memory). The same module is
the rank entry point (``python -m
crosscoder_tpu_torch.resilience.elastic_drill --proc N --mode M ...``): a
rank prints one ``{"ready": true}`` handshake line, then exactly one result
JSON as the LAST stdout line. Parent mode (no ``--proc``) runs a whole
drill and prints its report as the last line.

The trainers take the Trainer's defaults (the batch prefetch on, so more
than one rank orders its launches by tickets). The source is the synthetic
one, as in the JAX drills, or (``source="harvest"``, preempt only) the
tiny LM pair harvested into the device store over a random corpus: the
mesh store on a grid of more than one data rank, whose re-mesh runs the
buffer's ``prepare_reshard``, ``reshard(refill=False)`` and the restore.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# one serve per step on the synthetic source, so die@N kills at step N's
# batch production: after the liveness probe, before the step's collectives
_DRILL = dict(steps=10, save_every=3, die_serve=7)

# hysteresis-only chaos, strictly below the loss threshold: seed=3 pins the
# flaky stream to skips at probes 3 and 7 (never consecutive; the straggler
# sits at probe 5), so with suspect_probes=3 the healthy rank absorbs every
# miss
_STABILITY = dict(steps=8, grace_s=2.5, suspect_probes=3,
                  chaos="flaky@2:0.4,slow@5:1500,seed=3")

# each collective of the drill's world gives up after this long (a torn
# gloo collective raises on the closed socket at once; this bounds one that
# does not); at least every drill's elastic_grace_s
_COLLECTIVE_TIMEOUT_S = 30.0

# source="harvest": the tiny LM pair (d_model 32) over 256 random sequences
# into the device store
_HARVEST = dict(seq_len=17, buffer_mult=16, model_batch_size=4, norm_calib_batches=2,
                hook_point="blocks.2.hook_resid_pre", buffer_device="hbm")

_ROOT = Path(__file__).resolve().parents[2]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _base_cfg(workdir: str, overrides: dict | None, **kw):
    from crosscoder_tpu_torch.config import CrossCoderConfig

    base = dict(d_in=32, dict_size=64, n_models=2, batch_size=16, num_tokens=16 * 200,
                enc_dtype="fp32", log_backend="null", checkpoint_dir=workdir,
                log_every=1, stop_poll_every=1)
    base.update(kw)
    base.update(overrides or {})
    return CrossCoderConfig(**base)


def _drill_cfg(workdir: str, *, n_data: int, model: int, elastic: str, chaos: str = "",
               source: str = "synthetic", overrides: dict | None = None):
    extra = _HARVEST if source == "harvest" else {}
    return _base_cfg(workdir, overrides, data_axis_size=n_data, model_axis_size=model,
                     save_every=_DRILL["save_every"], elastic=elastic,
                     elastic_heartbeat_s=1.0, elastic_grace_s=3.0, chaos=chaos, **extra)


def _harvest_buffer(cfg, mesh, device):
    """The tiny LM pair harvested into ``cfg``'s store on ``mesh``."""
    import numpy as np

    from crosscoder_tpu_torch.data.buffer import make_buffer
    from crosscoder_tpu_torch.models import lm

    lm_cfg = lm.LMConfig.tiny()
    params = [lm.init_params(lm_cfg, seed=s, device=device) for s in (0, 1)]
    tokens = np.random.default_rng(7).integers(1, lm_cfg.vocab_size,
                                               size=(256, cfg.seq_len), dtype=np.int64)
    return make_buffer(cfg, lm_cfg, params, tokens, mesh=mesh, device=device)


def _stability_cfg(workdir: str, *, chaos: str = "", overrides: dict | None = None):
    return _base_cfg(workdir, overrides, data_axis_size=2, model_axis_size=1,
                     save_every=50, elastic="on", elastic_heartbeat_s=1.0,
                     elastic_grace_s=_STABILITY["grace_s"],
                     elastic_suspect_probes=_STABILITY["suspect_probes"], chaos=chaos)


class _LossTape:
    """Duck-typed MetricsLogger capturing (step, loss-bits) pairs and the
    loop's ``step_time_ms``."""

    def __init__(self) -> None:
        self.rows: list[tuple[int, str]] = []
        self.step_ms: list[tuple[int, float]] = []

    def log(self, scalars: dict, step: int) -> None:
        if "loss" in scalars:
            # hex round-trips the exact float64 of the fetched f32 loss: the
            # bitwise-equality channel between processes
            self.rows.append((step, float(scalars["loss"]).hex()))
        if "step_time_ms" in scalars:
            self.step_ms.append((step, float(scalars["step_time_ms"])))

    def close(self) -> None:
        pass


def _launch_counts() -> dict[str, int]:
    """The training kernels' launch counters (0 on the CPU, where the
    wrappers run their plain versions)."""
    from crosscoder_tpu_torch.ops import adam
    from crosscoder_tpu_torch.ops import sparse_grad as sg
    from crosscoder_tpu_torch.ops import topk_pallas as tp

    return {"topk_mask": tp.topk.launches, "sparsify": tp.sparsify.launches,
            "scatter_add_rows": sg.scatter_add_rows.launches,
            "adam_update": adam.adam_update.launches}


def _reset_launches() -> None:
    from crosscoder_tpu_torch.ops import adam
    from crosscoder_tpu_torch.ops import sparse_grad as sg
    from crosscoder_tpu_torch.ops import topk_pallas as tp

    for fn in (tp.topk, tp.sparsify, sg.scatter_add_rows, adam.adam_update):
        fn.launches = 0


def _timed(obj, name: str, into: dict, key: str):
    """``obj.name`` wrapped to add its wall ms to ``into[key]``; returns the
    original, for the caller to put back."""
    fn = getattr(obj, name)

    def run(*a, **k):
        t0 = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            into[key] = into.get(key, 0.0) + 1000 * (time.perf_counter() - t0)

    setattr(obj, name, run)
    return fn


def _child(args: argparse.Namespace) -> dict:
    stamps = {"start": time.time()}
    import torch

    from crosscoder_tpu_torch.checkpoint import Checkpointer
    from crosscoder_tpu_torch.parallel import mesh as mesh_lib
    from crosscoder_tpu_torch.parallel import multihost
    from crosscoder_tpu_torch.resilience.chaos import Chaos
    from crosscoder_tpu_torch.resilience.elastic import PeerLoss
    from crosscoder_tpu_torch.train.trainer import Trainer

    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0) if args.device == "cuda" else torch.device("cpu")
    overrides = json.loads(args.cfg) if args.cfg else None
    if args.mode == "clean":
        # the reference leg: a fresh world of the survivors' shape, restoring
        # the exact save they resumed from
        multihost.initialize(device, init_method=f"tcp://127.0.0.1:{args.port}",
                             world_size=args.world, rank=args.proc, backend="gloo")
        steps = _DRILL["steps"]
        # its own checkpoint_dir: what it writes (a trace under obs) stays apart
        cfg = _drill_cfg(os.path.join(args.workdir, "clean"), n_data=args.world // args.model,
                         model=args.model, elastic="off", source=args.source,
                         overrides=overrides)
    else:
        multihost.elastic_initialize(f"127.0.0.1:{args.port}", args.world, args.proc,
                                     device=device, backend="gloo",
                                     timeout_s=_COLLECTIVE_TIMEOUT_S,
                                     local_world_size=args.local)
        if args.mode == "stability":
            steps = _STABILITY["steps"]
            cfg = _stability_cfg(args.workdir, overrides=overrides,
                                 chaos=_STABILITY["chaos"] if args.proc == 1 else "")
        else:   # preempt: every rank off the coordinator host dies
            steps = _DRILL["steps"]
            die = f"die@{_DRILL['die_serve']}" if args.proc >= args.local else ""
            cfg = _drill_cfg(args.workdir, n_data=args.world // args.model, model=args.model,
                             elastic="on", chaos=die, source=args.source,
                             overrides=overrides)
    stamps["joined"] = time.time()
    mesh = mesh_lib.mesh_from_cfg(cfg)
    buffer = _harvest_buffer(cfg, mesh, device) if args.source == "harvest" else None
    tape = _LossTape()
    # the stability drill restores nothing and needs no save
    ckpt = None if args.mode == "stability" else Checkpointer(args.workdir)
    tr = Trainer(cfg, buffer, mesh=mesh, logger=tape, device=device, checkpointer=ckpt,
                 chaos=Chaos.from_cfg_env(cfg))
    # only the trainer and the buffer hold the grid, and a re-mesh lets go
    # of it: leaving the old world then closes its groups' connections
    del mesh, buffer
    report: dict = {"proc": args.proc, "remesh_split": {}}
    remesh = tr._remesh_and_resume

    def remesh_and_report(cause: BaseException) -> None:
        # how the loss was found, the launches made before the re-mesh, and
        # where its time went: the wait for a save in flight, the regroup,
        # the restore
        stamps["remesh"] = time.time()
        report["detected_by"] = "probe" if isinstance(cause, PeerLoss) else "torn collective"
        report["cause"] = f"{type(cause).__name__}: {cause}"[:300]
        report["launches_before"] = _launch_counts()
        split = report["remesh_split"]
        saved = [(ckpt, "wait", _timed(ckpt, "wait", split, "save_wait_ms")),
                 (tr._elastic, "shrink", _timed(tr._elastic, "shrink", split, "shrink_ms")),
                 (tr, "restore", _timed(tr, "restore", split, "restore_ms"))]
        try:
            remesh(cause)
        finally:
            for obj, name, fn in saved:
                setattr(obj, name, fn)
            stamps["resumed"] = time.time()

    tr._remesh_and_resume = remesh_and_report
    stamps["built"] = time.time()
    print(json.dumps({"proc": args.proc, "ready": True}), flush=True)
    if args.restore_save >= 0:
        tr.restore(version_dir=os.path.join(args.workdir, "version_0"), save=args.restore_save)
        # the reference writes nothing: the survivor's saves stay as it left them
        tr.checkpointer = None
        stamps["restored"] = time.time()
    if args.device == "cuda":
        torch.cuda.synchronize()
    _reset_launches()
    tr.train(num_steps=steps)
    if args.device == "cuda":
        torch.cuda.synchronize()
    stamps["trained"] = time.time()
    report.update(losses=tape.rows, step_ms=tape.step_ms, remesh=tr.last_remesh,
                  counters=tr.resilience.snapshot(), final_step=int(tr.state.step),
                  launches=_launch_counts(), epoch=tr._elastic.epoch() if tr._elastic else 0,
                  buffer=type(tr.buffer).__name__,
                  grid=[tr.mesh.data_size, tr.mesh.model_size], stamps=stamps)
    tr.close()
    multihost.shutdown()
    return report


def _spawn(workdir: str, proc: int, port: int, *, world: int, local: int, model: int,
           device: str, mode: str = "preempt", source: str = "synthetic",
           overrides: dict | None = None, restore_save: int = -1,
           stderr_path: str | None = None) -> subprocess.Popen:
    env = dict(os.environ)
    # ranks must not inherit an outer chaos or group opt-in
    for k in ("CROSSCODER_CHAOS", "WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT",
              "LOCAL_RANK"):
        env.pop(k, None)
    env["LOCAL_WORLD_SIZE"] = str(local)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(_ROOT), env.get("PYTHONPATH", "")) if p)
    if device == "cpu":
        env.setdefault("OMP_NUM_THREADS", "1")    # the ranks share the host's cores
    cmd = [sys.executable, "-m", "crosscoder_tpu_torch.resilience.elastic_drill",
           "--proc", str(proc), "--world", str(world), "--local", str(local),
           "--model", str(model), "--port", str(port), "--workdir", workdir,
           "--restore-save", str(restore_save), "--mode", mode, "--device", device,
           "--source", source]
    if overrides:
        cmd += ["--cfg", json.dumps(overrides)]
    err = open(stderr_path, "w") if stderr_path else None
    try:
        return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.DEVNULL if err is None else err,
                                text=True, env=env)
    finally:
        if err is not None:
            err.close()         # the rank holds its own descriptor


def _result(p: subprocess.Popen, timeout: float) -> dict:
    out, _ = p.communicate(timeout=timeout)
    lines = [ln for ln in out.strip().splitlines() if ln.strip()]
    if not lines:
        raise RuntimeError(f"drill rank produced no output (exit {p.returncode})")
    return json.loads(lines[-1])


def _dedup_last(rows: list, from_step: int) -> list[tuple[int, str]]:
    """A survivor logs replayed steps twice (before the fault and after the
    recovery); keep the LAST run of each step at or past ``from_step``."""
    seen: dict[int, str] = {}
    for s, h in rows:
        if s >= from_step:
            seen[s] = h
    return sorted(seen.items())


def _kill_all(ps: list[subprocess.Popen]) -> None:
    for p in ps:
        if p.poll() is None:
            p.kill()
            p.wait()


def _device_type(device) -> str:
    """``"cuda"`` or ``"cpu"``: the card unless the caller names the CPU."""
    from crosscoder_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device).type
    if dev not in ("cuda", "cpu"):
        raise ValueError(f"a drill runs on cuda or cpu, got {device!r}")
    return dev


def run_drill(workdir: str | None = None, timeout: float = 420.0, keep_logs: bool = False,
              *, world: int = 2, local: int = 1, model: int = 1, device=None,
              source: str = "synthetic", overrides: dict | None = None) -> dict:
    """The preemption drill; returns a report with

    - ``survivor``: rank 0's result (losses, the re-mesh, counters, launches),
      ``survivors`` every coordinator-host rank's;
    - ``restart``: clean rank 0 restoring the same save at the survivors' shape;
    - ``post_losses`` / ``restart_losses``: the aligned post-remesh
      trajectories (same steps, loss float hex) and ``bitwise_equal``;
    - ``remesh_ms``, ``resume_step``, ``detected_by``, ``epoch``.

    Raises on a structural failure (a survivor that died or never
    re-meshed, a rank off the coordinator host that exited cleanly, a
    restart that could not restore); leaves the equality verdict to the
    caller. ``overrides`` (config fields) size the run; ``device`` (default
    the card) places every rank; ``source`` is ``"synthetic"`` or
    ``"harvest"`` (module docstring)."""
    if world % local or local % model or world <= local:
        raise ValueError(f"a drill needs hosts of {local} ranks, more than one of them, and "
                         f"model {model} dividing a host: got world {world}")
    if source not in ("synthetic", "harvest"):
        raise ValueError(f"source must be synthetic|harvest, got {source!r}")
    device = _device_type(device)
    tmp = None
    if workdir is None:
        tmp = tempfile.TemporaryDirectory(prefix="elastic_drill_")
        workdir = tmp.name
    Path(workdir).mkdir(parents=True, exist_ok=True)
    spawned: list[subprocess.Popen] = []
    try:
        logs = str(Path(workdir) / "drill_proc{}.err")
        port = _free_port()
        t_pair = time.time()
        spawned += [_spawn(workdir, r, port, world=world, local=local, model=model,
                           device=device, source=source, overrides=overrides,
                           stderr_path=logs.format(r) if keep_logs else None)
                    for r in range(world)]
        survivors = [_result(spawned[r], timeout) for r in range(local)]
        for r, p in enumerate(spawned):
            p.wait(timeout=60)
            if r < local and p.returncode != 0:
                raise RuntimeError(f"survivor rank {r} exited {p.returncode}")
            if r >= local and p.returncode == 0:
                raise RuntimeError(f"rank {r} exited cleanly; die@ chaos never fired")
        survivor = survivors[0]
        remesh = survivor.get("remesh")
        if not remesh or remesh.get("save", -1) < 0:
            raise RuntimeError(f"survivor never re-meshed: {survivor}")
        cport = _free_port()
        t_clean = time.time()
        clean = [_spawn(workdir, r, cport, world=local, local=local, model=model,
                        mode="clean", device=device, source=source, overrides=overrides,
                        restore_save=remesh["save"],
                        stderr_path=logs.format(f"c{r}") if keep_logs else None)
                 for r in range(local)]
        spawned += clean
        restarts = [_result(p, timeout) for p in clean]
        for p in clean:
            p.wait(timeout=60)
            if p.returncode != 0:
                raise RuntimeError(f"clean restart rank exited {p.returncode}")
        restart = restarts[0]
        resume_step = remesh["step"]
        post = _dedup_last(survivor["losses"], resume_step)
        restart_post = [tuple(r) for r in restart["losses"] if r[0] >= resume_step]
        return {
            "survivor": survivor,
            "survivors": survivors,
            "restart": restart,
            "post_losses": post,
            "restart_losses": restart_post,
            "bitwise_equal": post == restart_post and len(post) > 0,
            "remesh_ms": remesh["remesh_ms"],
            "resume_step": resume_step,
            "detected_by": survivor.get("detected_by"),
            "epoch": remesh["epoch"],
            "steps": _DRILL["steps"],
            "spawned": {"pair": t_pair, "clean": t_clean},
        }
    finally:
        _kill_all(spawned)
        if tmp is not None:
            tmp.cleanup()


def run_stability_drill(workdir: str | None = None, timeout: float = 300.0,
                        keep_logs: bool = False, *, device=None,
                        overrides: dict | None = None) -> dict:
    """Flaky and slow chaos below the hysteresis threshold on two ranks:
    the pair must finish together with ZERO remeshes while the counters
    show the faults fired (``stable`` holds both). ``device`` as
    :func:`run_drill`'s."""
    device = _device_type(device)
    steps = _STABILITY["steps"]
    tmp = None
    if workdir is None:
        tmp = tempfile.TemporaryDirectory(prefix="stability_drill_")
        workdir = tmp.name
    Path(workdir).mkdir(parents=True, exist_ok=True)
    ps: list[subprocess.Popen] = []
    try:
        logs = str(Path(workdir) / "stability_proc{}.err")
        port = _free_port()
        ps = [_spawn(workdir, r, port, world=2, local=1, model=1, mode="stability",
                     device=device, overrides=overrides,
                     stderr_path=logs.format(r) if keep_logs else None)
              for r in (0, 1)]
        results = [_result(p, timeout) for p in ps]
        for p in ps:
            p.wait(timeout=60)
        if any(p.returncode != 0 for p in ps):
            raise RuntimeError(f"stability pair exited {ps[0].returncode}/{ps[1].returncode}")
        c0, c1 = results[0]["counters"], results[1]["counters"]
        remeshes = c0.get("resilience/remeshes", 0) + c1.get("resilience/remeshes", 0)
        suspects = c0.get("resilience/elastic_suspects", 0)
        slow = c0.get("resilience/elastic_slow_probes", 0)
        skipped = c1.get("resilience/elastic_skipped_probes", 0)
        finished = all(r["final_step"] == steps for r in results)
        return {
            "procs": results,
            "remeshes": remeshes,
            "suspects": suspects,
            "slow_probes": slow,
            "skipped_probes": skipped,
            "finished": finished,
            # zero spurious remeshes AND the chaos demonstrably fired
            "stable": (remeshes == 0 and finished and suspects >= 1 and slow >= 1
                       and skipped >= 1),
            "steps": steps,
        }
    finally:
        _kill_all(ps)
        if tmp is not None:
            tmp.cleanup()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--proc", type=int, default=None,
                    help="rank mode: this rank of the drill's world")
    ap.add_argument("--mode", default="preempt", choices=("preempt", "stability", "clean"),
                    help="parent: which drill to run; rank: which role")
    ap.add_argument("--world", type=int, default=2, help="ranks of the drill's world")
    ap.add_argument("--local", type=int, default=1, help="ranks a host (host-major)")
    ap.add_argument("--model", type=int, default=1, help="the grid's model axis (TP width)")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--restore-save", type=int, default=-1)
    ap.add_argument("--device", default=None, choices=("cpu", "cuda"),
                    help="where every rank runs (default: the card)")
    ap.add_argument("--source", default="synthetic", choices=("synthetic", "harvest"),
                    help="the preempt drill's batches (module docstring)")
    ap.add_argument("--cfg", default=None, help="config field overrides, as JSON")
    ap.add_argument("--keep-logs", action="store_true")
    args = ap.parse_args(argv)
    if args.mode == "stability" and args.source != "synthetic":
        ap.error("the stability drill runs on the synthetic source")
    overrides = json.loads(args.cfg) if args.cfg else None
    if args.proc is None:
        if args.mode == "stability":
            report = run_stability_drill(workdir=args.workdir, keep_logs=args.keep_logs,
                                         device=args.device, overrides=overrides)
            print(json.dumps({k: report[k] for k in ("stable", "remeshes", "suspects",
                                                     "skipped_probes", "slow_probes")}))
            return 0 if report["stable"] else 1
        report = run_drill(workdir=args.workdir, keep_logs=args.keep_logs, world=args.world,
                           local=args.local, model=args.model, device=args.device,
                           source=args.source, overrides=overrides)
        print(json.dumps({"bitwise_equal": report["bitwise_equal"],
                          "remesh_ms": report["remesh_ms"],
                          "resume_step": report["resume_step"],
                          "detected_by": report["detected_by"], "epoch": report["epoch"],
                          "post_steps": len(report["post_losses"])}))
        return 0 if report["bitwise_equal"] else 1
    args.device = _device_type(args.device)
    print(json.dumps(_child(args)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
