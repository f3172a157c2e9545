"""Elasticity drills, ported from :mod:`crosscoder_tpu.resilience.elastic_drill`.

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
- **autoscale**: :func:`run_autoscale_drill`, the whole grow/shrink/grow
  cycle in one run. The world starts wide; ``die@S`` kills the second host,
  the survivors shrink and replay; ``return@S`` then models the fleet
  granting capacity back (a grant on the rendezvous board), and a PARKED
  returned host (``local`` ranks, its local rank 0 announcing for all of
  them) passes the debounce; the survivors grow the world back to the wide
  shape at a step boundary and every member restores the admission's
  boundary save. The survivors' losses after the grow must equal a clean
  wide world's restoring the same save (``restore_dir``, ``restore_save``),
  and the joiner's the survivors'. With ``vanish=True`` the returned host
  dies after it is admitted and before the rendezvous: the survivors count
  a ``grow_abort``, burn the failed epoch and finish narrow.
- **stability**: probe-path chaos only on rank 1 (``flaky@S:p``, skipped
  barriers; ``slow@S:ms``, a straggler), both below the hysteresis
  threshold: the pair must finish with ZERO remeshes while the counters
  show the faults fired.

Every rank runs on the one card unless the caller names the CPU
(``device="cpu"``, ``--device cpu``); with neither and no card the drill
raises. The ranks are gloo ranks either way (on the card they share it,
and gloo stages each collective through host memory). The same module is
the rank entry point (``python -m
crosscoder_tpu_torch.resilience.elastic_drill --proc N --mode M ...``; modes
``preempt``, ``autoscale``, ``stability``, ``clean`` and ``rejoin``): a
rank prints one ``{"ready": true}`` handshake line, then exactly one result
JSON as the LAST stdout line. Parent mode (no ``--proc``) runs a whole
drill (``--mode preempt|autoscale|stability``) and prints its report as the
last line.

The trainers take the Trainer's defaults (the batch prefetch on, so more
than one rank orders its launches by tickets). The source is the synthetic
one, as in the JAX drills, or (``source="harvest"``, the preempt and
autoscale drills) the tiny LM pair harvested into the device store over a
random corpus: the mesh store on a grid of more than one data rank, whose
re-mesh and grow run the buffer's ``prepare_reshard``,
``reshard(refill=False)`` and the restore (a joiner builds its store lazy
and fills it from the boundary save's stream position).
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

# the whole autoscale cycle: die, shrink, the return grant, the debounced
# rejoin, grow, in one run. Serve-indexed chaos on the survivors: with the
# death at serve 6 and the newest save at step 4, the replay after the shrink
# passes serve 10, where return@10 posts the grant; the stalls behind it
# throttle the survivors' steps (0.4 s each) so the parked rejoiner's
# courtship (the grant poll, then announce beats) lands within the steps
# left, however fast the host steps
_AUTOSCALE = dict(steps=20, save_every=4, die_serve=6, return_serve=10, dwell=2, debounce=2,
                  stall_from=11, stall_to=17, stall_s=0.4)

_REJOIN_WAIT_S = 240.0   # the parked rejoiner's patience for the grant
_REJOIN_ID = "rejoin0"   # the returned host's candidate id

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


def _autoscale_cfg(workdir: str, *, n_data: int, model: int, elastic: str = "on",
                   chaos: str = "", source: str = "synthetic", overrides: dict | None = None):
    extra = _HARVEST if source == "harvest" else {}
    return _base_cfg(workdir, overrides, data_axis_size=n_data, model_axis_size=model,
                     num_tokens=16 * 400, save_every=_AUTOSCALE["save_every"], elastic=elastic,
                     elastic_heartbeat_s=1.0, elastic_grace_s=3.0, elastic_grow=elastic,
                     elastic_dwell_steps=_AUTOSCALE["dwell"],
                     elastic_grow_debounce=_AUTOSCALE["debounce"], chaos=chaos, **extra)


def _autoscale_chaos(proc: int, local: int) -> str:
    """Every rank off the coordinator host dies; the survivors post the
    grant and stall behind it."""
    if proc >= local:
        return f"die@{_AUTOSCALE['die_serve']}"
    stalls = ",".join(f"stall@{s}:{_AUTOSCALE['stall_s']}"
                      for s in range(_AUTOSCALE["stall_from"], _AUTOSCALE["stall_to"] + 1))
    return f"return@{_AUTOSCALE['return_serve']},{stalls}"


def _harvest_buffer(cfg, mesh, device, lazy: bool = False):
    """The tiny LM pair harvested into ``cfg``'s store on ``mesh`` (``lazy``:
    neither calibrated nor filled until a restore gives it a position)."""
    import numpy as np

    from crosscoder_tpu_torch.data.buffer import make_buffer
    from crosscoder_tpu_torch.models import lm

    lm_cfg = lm.LMConfig.tiny()
    params = [lm.init_params(lm_cfg, seed=s, device=device) for s in (0, 1)]
    tokens = np.random.default_rng(7).integers(1, lm_cfg.vocab_size,
                                               size=(256, cfg.seq_len), dtype=np.int64)
    return make_buffer(cfg, lm_cfg, params, tokens, mesh=mesh, device=device, lazy=lazy)


def _stability_cfg(workdir: str, *, chaos: str = "", overrides: dict | None = None):
    return _base_cfg(workdir, overrides, data_axis_size=2, model_axis_size=1,
                     save_every=50, elastic="on", elastic_heartbeat_s=1.0,
                     elastic_grace_s=_STABILITY["grace_s"],
                     elastic_suspect_probes=_STABILITY["suspect_probes"], chaos=chaos)


class _LossTape:
    """The (step, loss-bits) pairs and the loop's ``step_time_ms`` of each
    log point: it stands in for ``Trainer.log``, so every rank records (the
    loss is global on every rank)."""

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


def _timed_around(report: dict, key: str, stamp: str, stamps: dict, targets):
    """A wrapper for a recovery method that fills ``report[key]`` with the
    wall ms of each ``(obj, name, split key)`` of ``targets`` while it runs
    and stamps ``stamps[stamp]`` at its start."""
    def wrap(method):
        def run(*a, **k):
            stamps[stamp] = time.time()
            split = report.setdefault(key, {})
            saved = [(obj, name, _timed(obj, name, split, sk)) for obj, name, sk in targets()]
            try:
                return method(*a, **k)
            finally:
                for obj, name, fn in saved:
                    setattr(obj, name, fn)
        return run
    return wrap


def _rank_setup(args: argparse.Namespace):
    """``(torch, device, overrides)`` of a drill rank."""
    import torch

    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0) if args.device == "cuda" else torch.device("cpu")
    return torch, device, json.loads(args.cfg) if args.cfg else None


def _child(args: argparse.Namespace) -> dict:
    stamps = {"start": time.time()}
    if args.mode == "rejoin":
        return _rejoin_child(args, stamps)
    torch, device, overrides = _rank_setup(args)

    from crosscoder_tpu_torch.checkpoint import Checkpointer
    from crosscoder_tpu_torch.parallel import mesh as mesh_lib
    from crosscoder_tpu_torch.parallel import multihost
    from crosscoder_tpu_torch.resilience.chaos import Chaos
    from crosscoder_tpu_torch.resilience.elastic import PeerLoss
    from crosscoder_tpu_torch.train.trainer import Trainer

    n_data = args.world // args.model
    if args.mode == "clean":
        # the reference leg: a fresh world of the survivors' shape (the
        # preempt drill) or the grown shape (the autoscale drill), restoring
        # the exact save they resumed from
        multihost.initialize(device, init_method=f"tcp://127.0.0.1:{args.port}",
                             world_size=args.world, rank=args.proc, backend="gloo")
        # its own checkpoint_dir: what it writes (a trace under obs) stays apart
        clean_dir = os.path.join(args.workdir, "clean")
        if args.of == "autoscale":
            steps = args.steps or _AUTOSCALE["steps"]
            cfg = _autoscale_cfg(clean_dir, n_data=n_data, model=args.model, elastic="off",
                                 source=args.source, overrides=overrides)
        else:
            steps = _DRILL["steps"]
            cfg = _drill_cfg(clean_dir, n_data=n_data, model=args.model, elastic="off",
                             source=args.source, overrides=overrides)
    else:
        multihost.elastic_initialize(f"127.0.0.1:{args.port}", args.world, args.proc,
                                     device=device, backend="gloo",
                                     timeout_s=args.collective_timeout_s,
                                     local_world_size=args.local)
        if args.mode == "stability":
            steps = _STABILITY["steps"]
            cfg = _stability_cfg(args.workdir, overrides=overrides,
                                 chaos=_STABILITY["chaos"] if args.proc == 1 else "")
        elif args.mode == "autoscale":
            steps = args.steps or _AUTOSCALE["steps"]
            cfg = _autoscale_cfg(args.workdir, n_data=n_data, model=args.model,
                                 chaos=_autoscale_chaos(args.proc, args.local),
                                 source=args.source, overrides=overrides)
        else:   # preempt: every rank off the coordinator host dies
            steps = _DRILL["steps"]
            die = f"die@{_DRILL['die_serve']}" if args.proc >= args.local else ""
            cfg = _drill_cfg(args.workdir, n_data=n_data, model=args.model,
                             elastic="on", chaos=die, source=args.source,
                             overrides=overrides)
    stamps["joined"] = time.time()
    mesh = mesh_lib.mesh_from_cfg(cfg)
    buffer = _harvest_buffer(cfg, mesh, device) if args.source == "harvest" else None
    tape = _LossTape()
    # the stability drill restores nothing and needs no save
    ckpt = None if args.mode == "stability" else Checkpointer(args.workdir)
    tr = Trainer(cfg, buffer, mesh=mesh, device=device, checkpointer=ckpt,
                 chaos=Chaos.from_cfg_env(cfg))
    tr.log = tape.log       # every rank's tape (a Trainer's logger writes on the primary only)
    # only the trainer and the buffer hold the grid, and a re-mesh lets go
    # of it: leaving the old world then closes its groups' connections
    del mesh, buffer
    report: dict = {"proc": args.proc, "remesh_split": {}}
    remesh = _timed_around(report, "remesh_split", "remesh", stamps, lambda: [
        (ckpt, "wait", "save_wait_ms"), (tr._elastic, "shrink", "shrink_ms"),
        (tr, "restore", "restore_ms")])(tr._remesh_and_resume)
    grow = _timed_around(report, "grow_split", "grow", stamps, lambda: [
        (tr, "save", "save_ms"), (tr._elastic, "grow", "regroup_ms"),
        (tr, "restore", "restore_ms")])(tr._grow_and_resume)

    def remesh_and_report(cause: BaseException) -> None:
        # how the loss was found and the launches made before the re-mesh;
        # where its time went: the wait for a save in flight, the regroup,
        # the restore
        report["detected_by"] = "probe" if isinstance(cause, PeerLoss) else "torn collective"
        report["cause"] = f"{type(cause).__name__}: {cause}"[:300]
        report["launches_before"] = _launch_counts()
        try:
            remesh(cause)
        finally:
            stamps["resumed"] = time.time()

    def grow_and_report(step: int) -> None:
        # the launches before the grow; its split: the boundary save, the
        # regroup (the admission and the rendezvous), the restore
        report["launches_before_grow"] = _launch_counts()
        try:
            grow(step)
        finally:
            stamps["grown"] = time.time()

    tr._remesh_and_resume = remesh_and_report
    tr._grow_and_resume = grow_and_report
    stamps["built"] = time.time()
    print(json.dumps({"proc": args.proc, "ready": True}), flush=True)
    if args.restore_save >= 0:
        rd = args.restore_dir or os.path.join(args.workdir, "version_0")
        tr.restore(version_dir=rd, save=args.restore_save)
        # the reference writes nothing: the survivors' saves stay as they left them
        tr.checkpointer = None
        stamps["restored"] = time.time()
    return _train_and_report(torch, tr, tape, steps, args, report, stamps)


def _train_and_report(torch, tr, tape, steps: int, args, report: dict, stamps: dict) -> dict:
    """Train ``tr`` to ``steps``, then the rank's report; leaves the world."""
    from crosscoder_tpu_torch.parallel import multihost

    if args.device == "cuda":
        torch.cuda.synchronize()
    _reset_launches()
    tr.train(num_steps=steps)
    if args.device == "cuda":
        torch.cuda.synchronize()
    stamps["trained"] = time.time()
    report.update(losses=tape.rows, step_ms=tape.step_ms, remesh=tr.last_remesh,
                  grow=tr.last_grow, counters=tr.resilience.snapshot(),
                  final_step=int(tr.state.step), launches=_launch_counts(),
                  epoch=tr._elastic.epoch() if tr._elastic else 0,
                  buffer=type(tr.buffer).__name__,
                  grid=[tr.mesh.data_size, tr.mesh.model_size], stamps=stamps)
    tr.close()
    multihost.shutdown()
    return report


def _await_admit(board, candidate_id: str, timeout_s: float) -> dict:
    """A returned host's other ranks: the admit record naming its host,
    read without announcing (its local rank 0 speaks for it)."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        admit = board.read_admit()
        if admit and candidate_id in admit.get("assignments", {}):
            return admit
        time.sleep(0.1)
    raise TimeoutError(f"rejoin host {candidate_id} was not admitted within {timeout_s:.0f}s")


def _rejoin_child(args: argparse.Namespace, stamps: dict) -> dict:
    """A rank of the returned host (``--proc`` its local rank): park on the
    rendezvous board until the fleet grants capacity back (the survivors'
    ``return@S``), court the coordinator (local rank 0 announces for the
    host), enter the grown world the admit record describes, hydrate from
    its boundary save and train beside the survivors to the end of the run.
    With ``--vanish`` it dies once admitted, before the rendezvous."""
    torch, device, overrides = _rank_setup(args)

    from crosscoder_tpu_torch.checkpoint import Checkpointer
    from crosscoder_tpu_torch.parallel import multihost
    from crosscoder_tpu_torch.resilience import elastic
    from crosscoder_tpu_torch.train.trainer import Trainer

    board = elastic.RendezvousBoard(Path(args.workdir) / "elastic_board")
    print(json.dumps({"proc": "rejoin", "ready": True}), flush=True)
    deadline = time.monotonic() + _REJOIN_WAIT_S
    while board.read_grant() is None:
        if time.monotonic() > deadline:
            raise TimeoutError("the rejoin host never saw a capacity grant")
        time.sleep(0.1)
    stamps["granted"] = time.time()
    if args.proc == 0:
        admit = board.announce_until_admitted(_REJOIN_ID, devices=args.local, timeout_s=120.0,
                                              beat_s=0.1)
    else:
        admit = _await_admit(board, _REJOIN_ID, 120.0)
    stamps["admitted"] = time.time()
    if args.vanish:
        print("[crosscoder_tpu_torch] drill: the admitted rejoin host vanishes before the "
              "rendezvous", flush=True, file=sys.stderr)
        os._exit(44)
    mesh = elastic.join_grown_world(admit, _REJOIN_ID, device=device, local_rank=args.proc)
    stamps["joined"] = time.time()
    cfg = _autoscale_cfg(args.workdir, n_data=int(admit["n_data"]),
                         model=int(admit["n_model"]), source=args.source, overrides=overrides)
    buffer = (_harvest_buffer(cfg, mesh, device, lazy=True) if args.source == "harvest"
              else None)
    tape = _LossTape()
    tr = Trainer(cfg, buffer, mesh=mesh, device=device, checkpointer=Checkpointer(args.workdir))
    tr.log = tape.log
    del mesh, buffer
    tr.restore(version_dir=admit["version_dir"], save=int(admit["save"]))
    # the hydration barrier, as the survivors' grow passes it: train only
    # once every member of the grown world has restored
    multihost.probe_liveness(f"r{int(admit['epoch'])}", timeout_s=120.0)
    stamps["restored"] = time.time()
    report = {"proc": "rejoin", "local_rank": args.proc, "admit": admit,
              "rank": multihost.rank()}
    return _train_and_report(torch, tr, tape, args.steps or _AUTOSCALE["steps"], args, report,
                             stamps)


def _spawn(workdir: str, proc: int, port: int, *, world: int, local: int, model: int,
           device: str, mode: str = "preempt", source: str = "synthetic",
           overrides: dict | None = None, restore_save: int = -1,
           restore_dir: str | None = None, of: str = "preempt", vanish: bool = False,
           collective_timeout_s: float | None = None, steps: int = 0,
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
    if restore_dir is not None:
        cmd += ["--restore-dir", restore_dir]
    if mode == "clean":
        cmd += ["--of", of]
    if vanish:
        cmd += ["--vanish"]
    if steps:
        cmd += ["--steps", str(steps)]
    if collective_timeout_s is not None:
        cmd += ["--collective-timeout-s", str(collective_timeout_s)]
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


def run_autoscale_drill(workdir: str | None = None, timeout: float = 600.0,
                        keep_logs: bool = False, *, world: int = 2, local: int = 1,
                        model: int = 1, device=None, source: str = "synthetic",
                        overrides: dict | None = None, vanish: bool = False,
                        collective_timeout_s: float | None = None, steps: int = 0) -> dict:
    """The autoscale cycle (grow, shrink, grow) over two hosts of ``local``
    ranks on a ``world // model`` × ``model`` grid; returns a report with

    - ``survivor`` / ``joiner`` / ``clean``: rank 0's result of each role
      (``survivors``, ``joiners``: every rank's);
    - ``post_losses``: the survivor's steps after the grow (the last run of
      each step); ``clean_losses`` / ``joiner_losses``, the references;
    - ``bitwise_equal``: the survivor after the grow == a clean wide world
      restoring the same save; ``joiner_equal``: the joiner == the survivor;
    - ``remesh_ms`` / ``grow_ms``, ``resume_step`` (the grow's), ``epoch``
      (the grow's), ``steps``, and the spawn times.

    ``vanish=True`` is the abort case: the returned host dies once admitted,
    before the rendezvous; the survivors must count one ``grow_abort`` and
    finish narrow, and no clean leg runs (``bitwise_equal`` and
    ``joiner_equal`` are None). ``collective_timeout_s`` bounds each
    collective of the world (the failed rendezvous waits out twice it).
    ``steps`` cuts the run's length (default JAX's 20; the grow lands
    around step 10, so fewer than about 14 may end the run before it).

    Raises on a structural failure (a survivor that died, never shrank or
    never tried the grow; a rank off the coordinator host that exited
    cleanly; a joiner that failed); leaves the equality verdicts to the
    caller. ``device``, ``source`` and ``overrides`` as :func:`run_drill`'s."""
    if world != 2 * local or local % model:
        raise ValueError(f"the autoscale drill runs two hosts of {local} ranks with model "
                         f"{model} dividing a host: got world {world}")
    if source not in ("synthetic", "harvest"):
        raise ValueError(f"source must be synthetic|harvest, got {source!r}")
    device = _device_type(device)
    tmp = None
    if workdir is None:
        tmp = tempfile.TemporaryDirectory(prefix="autoscale_drill_")
        workdir = tmp.name
    Path(workdir).mkdir(parents=True, exist_ok=True)
    spawned: list[subprocess.Popen] = []
    kw = dict(world=world, local=local, model=model, device=device, source=source,
              overrides=overrides, collective_timeout_s=collective_timeout_s, steps=steps)
    try:
        logs = str(Path(workdir) / "autoscale_proc{}.err")
        t_pair = time.time()
        rejoin = [_spawn(workdir, r, 0, mode="rejoin", vanish=vanish,
                         stderr_path=logs.format(f"j{r}") if keep_logs else None, **kw)
                  for r in range(local)]
        spawned += rejoin
        port = _free_port()
        ranks = [_spawn(workdir, r, port, mode="autoscale",
                        stderr_path=logs.format(r) if keep_logs else None, **kw)
                 for r in range(world)]
        spawned += ranks
        survivors = [_result(ranks[r], timeout) for r in range(local)]
        joiners = [] if vanish else [_result(p, 180.0) for p in rejoin]
        for r, p in enumerate(ranks):
            p.wait(timeout=60)
            if r < local and p.returncode != 0:
                raise RuntimeError(f"survivor rank {r} exited {p.returncode}")
            if r >= local and p.returncode == 0:
                raise RuntimeError(f"rank {r} exited cleanly; die@ chaos never fired")
        for p in rejoin:
            p.wait(timeout=60)
            if (p.returncode == 0) == vanish:
                raise RuntimeError(f"a rejoin rank exited {p.returncode}"
                                   f"{' (it was to vanish)' if vanish else ''}")
        survivor = survivors[0]
        remesh, grow = survivor.get("remesh"), survivor.get("grow")
        if not remesh or remesh.get("save", -1) < 0:
            raise RuntimeError(f"survivor never shrank: {survivor}")
        if not grow or grow.get("grown") == vanish:
            raise RuntimeError(f"survivor's grow {'grew' if vanish else 'never grew'}: "
                               f"{survivor}")
        report = {
            "survivor": survivor, "survivors": survivors, "joiners": joiners,
            "joiner": joiners[0] if joiners else None,
            "remesh_ms": remesh["remesh_ms"], "grow_ms": grow["grow_ms"],
            "resume_step": grow["step"], "epoch": grow["epoch"],
            "steps": steps or _AUTOSCALE["steps"], "spawned": {"pair": t_pair},
            "bitwise_equal": None, "joiner_equal": None,
        }
        post = _dedup_last(survivor["losses"], grow["step"])
        report["post_losses"] = post
        if vanish:
            return report
        # the reference leg: a FRESH wide world restoring the exact boundary
        # save the grown world hydrated from
        cport = _free_port()
        report["spawned"]["clean"] = time.time()
        clean = [_spawn(workdir, r, cport, mode="clean", of="autoscale",
                        restore_save=grow["save"], restore_dir=grow["version_dir"],
                        stderr_path=logs.format(f"c{r}") if keep_logs else None, **kw)
                 for r in range(world)]
        spawned += clean
        cleans = [_result(p, timeout) for p in clean]
        for p in clean:
            p.wait(timeout=60)
            if p.returncode != 0:
                raise RuntimeError(f"a clean rank exited {p.returncode}")
        clean_post = [tuple(r) for r in cleans[0]["losses"] if r[0] >= grow["step"]]
        joiner_post = [tuple(r) for r in joiners[0]["losses"] if r[0] >= grow["step"]]
        report.update(clean=cleans[0], clean_losses=clean_post, joiner_losses=joiner_post,
                      bitwise_equal=post == clean_post and len(post) > 0,
                      joiner_equal=joiner_post == post and len(joiner_post) > 0)
        return report
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
    ap.add_argument("--mode", default="preempt",
                    choices=("preempt", "autoscale", "stability", "clean", "rejoin"),
                    help="parent: which drill to run; rank: which role")
    ap.add_argument("--world", type=int, default=2, help="ranks of the drill's world")
    ap.add_argument("--local", type=int, default=1, help="ranks a host (host-major)")
    ap.add_argument("--model", type=int, default=1, help="the grid's model axis (TP width)")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--restore-save", type=int, default=-1)
    ap.add_argument("--restore-dir", default=None,
                    help="the clean leg's version dir (default <workdir>/version_0)")
    ap.add_argument("--of", default="preempt", choices=("preempt", "autoscale"),
                    help="the drill a clean leg is the reference of")
    ap.add_argument("--vanish", action="store_true",
                    help="autoscale: the returned host dies once admitted (the abort case)")
    ap.add_argument("--collective-timeout-s", type=float, default=_COLLECTIVE_TIMEOUT_S,
                    help="the bound of each collective of the drill's world")
    ap.add_argument("--steps", type=int, default=0,
                    help="autoscale: the run's steps (default 20, JAX's)")
    ap.add_argument("--device", default=None, choices=("cpu", "cuda"),
                    help="where every rank runs (default: the card)")
    ap.add_argument("--source", default="synthetic", choices=("synthetic", "harvest"),
                    help="the preempt and autoscale drills' batches (module docstring)")
    ap.add_argument("--cfg", default=None, help="config field overrides, as JSON")
    ap.add_argument("--keep-logs", action="store_true")
    args = ap.parse_args(argv)
    if args.mode == "stability" and args.source != "synthetic":
        ap.error("the stability drill runs on the synthetic source")
    if args.proc is None and args.mode in ("clean", "rejoin"):
        ap.error(f"--mode {args.mode} is a rank's role (with --proc), not a drill")
    overrides = json.loads(args.cfg) if args.cfg else None
    if args.proc is None:
        if args.mode == "autoscale":
            report = run_autoscale_drill(workdir=args.workdir, keep_logs=args.keep_logs,
                                         world=args.world, local=args.local, model=args.model,
                                         device=args.device, source=args.source,
                                         overrides=overrides, vanish=args.vanish,
                                         collective_timeout_s=args.collective_timeout_s,
                                         steps=args.steps)
            print(json.dumps({k: report[k] for k in (
                "bitwise_equal", "joiner_equal", "remesh_ms", "grow_ms", "resume_step",
                "epoch")} | {"post_steps": len(report["post_losses"]),
                             "counters": report["survivor"]["counters"]}))
            if args.vanish:
                return 0 if report["survivor"]["counters"].get(
                    "resilience/grow_aborts") == 1 else 1
            return 0 if report["bitwise_equal"] and report["joiner_equal"] else 1
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
