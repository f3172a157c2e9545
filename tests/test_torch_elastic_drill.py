"""The port's elasticity drills (crosscoder_tpu_torch/resilience/elastic_drill.py)
on gloo ranks on the CPU, the cases of tests/test_elastic.py's drills and
the port's own default setup:

- the preempt drill at 2 x 1 (two processes, one a host): rank 1 dies at
  serve 7, rank 0 re-meshes once (epoch 1) and finishes; its losses after
  the re-mesh are bitwise a clean one-rank restart's from the same save,
  and within the trainer bars (rtol 2e-4, atol 2e-5) of the JAX
  single-device Trainer restoring that save (its params, optimizer state
  and stream position);
- the preempt drill at two hosts of two ranks, data 2 x model 2: host 1
  dies, host 0's ranks shrink to 1 x 2 (the TP width kept), bitwise a clean
  two-rank restart;
- the preempt drill over the harvested mesh store (the tiny LM pair): the
  survivor's buffer goes through ``prepare_reshard``, ``reshard(refill=False)``
  and the restore, bitwise a clean restart's device store;
- the preempt drill with the batch prefetch off (every other drill runs
  the Trainer's default, on, whose ranks order their launches by tickets);
- the stability drill: flaky and slow probes below the threshold, zero
  remeshes, every chaos counter at least 1.

Each drill runs under its own time limit (the ``timeout`` its ranks get).
"""

import json

import pytest

import numpy as np

import jax

from crosscoder_tpu.checkpoint import Checkpointer as JCheckpointer
from crosscoder_tpu.config import CrossCoderConfig as JCfg
from crosscoder_tpu.data.synthetic import SyntheticActivationSource as JSource
from crosscoder_tpu.parallel import mesh as jmesh
from crosscoder_tpu.train import trainer as jtrainer
from crosscoder_tpu_torch.resilience import elastic_drill as drill


def _check_survivor(report, model):
    assert report["bitwise_equal"], {"post": report["post_losses"],
                                     "restart": report["restart_losses"]}
    assert report["epoch"] == 1
    assert report["detected_by"] in ("probe", "torn collective")
    first = report["survivor"]["remesh"]
    for surv in report["survivors"]:
        remesh = surv["remesh"]
        assert surv["counters"].get("resilience/remeshes") == 1
        assert surv["counters"].get("resilience/remesh_ms", 0) == remesh["remesh_ms"]
        assert {k: remesh[k] for k in ("step", "save", "epoch")} == \
            {k: first[k] for k in ("step", "save", "epoch")}
        assert surv["final_step"] == report["steps"]
        assert surv["grid"] == [1, model]          # the TP width kept
    # the survivors resumed from the newest save before the death
    assert report["resume_step"] == first["step"] < drill._DRILL["die_serve"]
    assert [s for s, _ in report["post_losses"]] == list(
        range(report["resume_step"], report["steps"]))


def test_preempt_drill_2x1_bitwise_and_against_jax(tmp_path):
    # the telemetry plane on (bitwise the same steps): the survivor's trace
    # holds the re-mesh's span
    report = drill.run_drill(workdir=str(tmp_path), timeout=90.0, keep_logs=True,
                             device="cpu", overrides={"obs": "on"})
    assert drill._drill_cfg(str(tmp_path), n_data=2, model=1, elastic="on").prefetch
    _check_survivor(report, model=1)
    spans = {e["name"] for f in (tmp_path / "obs").glob("trace*.json")
             for e in json.loads(f.read_text())["traceEvents"] if e["ph"] == "X"}
    assert {"remesh", "restore", "step"} <= spans, spans
    # the JAX single-device Trainer from the save the survivor restored
    remesh = report["survivor"]["remesh"]
    port_cfg = drill._drill_cfg(str(tmp_path), n_data=1, model=1, elastic="off")
    cfg = JCfg(**{f: getattr(port_cfg, f) for f in (
        "d_in", "dict_size", "n_models", "batch_size", "num_tokens", "enc_dtype",
        "log_backend", "prefetch", "log_every", "save_every", "stop_poll_every")},
        checkpoint_dir=str(tmp_path / "jax"))
    jtr = jtrainer.Trainer(cfg, JSource(cfg), mesh=jmesh.make_mesh(devices=jax.devices()[:1]),
                           checkpointer=JCheckpointer(base_dir=tmp_path))
    meta = jtr.restore(version_dir=tmp_path / "version_0", save=remesh["save"])
    assert meta["step"] == remesh["step"]
    want = [float(jtr.step()["loss"]) for _ in range(remesh["step"], report["steps"])]
    got = [float.fromhex(h) for _, h in report["post_losses"]]
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_preempt_drill_two_hosts_of_two_ranks_keeps_the_tp_width(tmp_path):
    report = drill.run_drill(workdir=str(tmp_path), timeout=120.0, world=4, local=2, model=2,
                             device="cpu")
    _check_survivor(report, model=2)
    assert len(report["survivors"]) == 2


def test_preempt_drill_over_the_harvested_mesh_store(tmp_path):
    report = drill.run_drill(workdir=str(tmp_path), timeout=90.0, device="cpu",
                             source="harvest")
    _check_survivor(report, model=1)
    assert report["survivor"]["buffer"] == "MeshPairedActivationBuffer"
    assert report["restart"]["buffer"] == "PairedActivationBuffer"


def test_preempt_drill_with_the_prefetch_off(tmp_path):
    report = drill.run_drill(workdir=str(tmp_path), timeout=90.0, device="cpu",
                             overrides={"prefetch": False})
    _check_survivor(report, model=1)


def test_preempt_drill_cut_to_fewer_steps(tmp_path):
    """``steps`` cuts the run (chip_smoke's leg EL takes 8 of the 10): the
    survivor resumes from the same save and finishes the shorter run,
    bitwise the restart; a run that ends before the death is refused."""
    with pytest.raises(ValueError, match="steps must exceed"):
        drill.run_drill(workdir=str(tmp_path / "short"), device="cpu",
                        steps=drill._DRILL["die_serve"])
    report = drill.run_drill(workdir=str(tmp_path), timeout=90.0, device="cpu", steps=8)
    assert report["steps"] == 8
    _check_survivor(report, model=1)
    assert len(report["post_losses"]) == 8 - report["resume_step"] >= 1


def test_stability_drill_zero_remeshes(tmp_path):
    report = drill.run_stability_drill(workdir=str(tmp_path), timeout=90.0, device="cpu")
    assert report["stable"], report
    assert report["remeshes"] == 0 and report["finished"]
    assert report["suspects"] >= 1        # a flake was absorbed...
    assert report["skipped_probes"] >= 1  # ...after the barrier skip fired
    assert report["slow_probes"] >= 1     # and the straggler was counted
