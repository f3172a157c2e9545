"""The port's mesh trainer on gloo ranks against the JAX mesh trainer.

From the same converted JAX state over the same synthetic stream, the
port's ``Trainer`` on 2 (``data``), 2 (``model``) and 2×2 gloo ranks
(``tests/_torch_parallel_child.py``) gives, after 5 steps, the params of
the JAX ``Trainer`` on a CPU mesh of the same shape and of the port's own
one-rank run, within the bar of ``tests/test_trainer.py::
test_sharded_equals_single_device`` (rtol 2e-4, atol 2e-5), for ReLU, TopK
with AuxK (the sparse backward plane), TopK with L1 (the dense mask) and
through the factored tier, JumpReLU with its L0 term and BatchTopK; at
step 0 it selects the JAX encoder's active latents. A one-rank grid runs
every collective and the merge, and is bitwise the single-device trainer. ``torchrun -m crosscoder_tpu_torch.train.main
--device cpu`` on 2 ranks logs and writes from the primary only.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from crosscoder_tpu.config import CrossCoderConfig as JCfg
from crosscoder_tpu.data.synthetic import SyntheticActivationSource as JSource
from crosscoder_tpu.models import crosscoder as jcc
from crosscoder_tpu.ops import fused_encoder_topk as jfek
from crosscoder_tpu.ops import sparse_grad as jsg
from crosscoder_tpu.ops import topk_pallas as jtp
from crosscoder_tpu.parallel import mesh as jmesh
from crosscoder_tpu.train import trainer as jtrainer
from crosscoder_tpu_torch import convert
from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.data.synthetic import SyntheticActivationSource
from crosscoder_tpu_torch.train.trainer import Trainer

from _torch_parallel_child import ROOT, run_ranks

STEPS = 5
BASE = dict(d_in=16, n_models=2, dict_size=64, batch_size=16, num_tokens=16 * STEPS,
            enc_dtype="fp32", log_backend="null", prefetch=False, seed=7, lr=5e-3,
            dec_init_norm=0.5)
CONFIGS = {
    "relu": dict(activation="relu", l1_coeff=2.0),
    "topk_auxk": dict(activation="topk", topk_k=4, l1_coeff=0.0, sparse_bwd="on", aux_k=8,
                      aux_dead_steps=1, aux_every=2),
    "topk_l1": dict(activation="topk", topk_k=4, l1_coeff=1.0),
    "topk_factored": dict(activation="topk", topk_k=4, l1_coeff=0.0, factored_decode="on",
                          sparse_bwd="off"),
    "jumprelu": dict(activation="jumprelu", l0_coeff=0.5, l1_coeff=0.0),
    "batchtopk": dict(activation="batchtopk", topk_k=4, l1_coeff=0.0),
}
SHAPES = {"dp2": (2, 1), "tp2": (1, 2), "dp2_tp2": (2, 2)}
RTOL, ATOL = 2e-4, 2e-5


@pytest.fixture(scope="module", autouse=True)
def _interpret_kernels():
    for m in (jtp, jsg, jfek):
        m.set_interpret(True)
    yield
    for m in (jtp, jsg, jfek):
        m.set_interpret(False)


def _jcfg(name):
    return JCfg(**{**BASE, **CONFIGS[name], "aux_exact_rank": True})


def _jax_run(name, d, m):
    cfg = _jcfg(name)
    tr = jtrainer.Trainer(cfg, JSource(cfg),
                          mesh=jmesh.make_mesh(d, m, devices=jax.devices()[:d * m]))
    state0 = jax.device_get(tr.state)
    losses = [float(tr.step()["loss"]) for _ in range(STEPS)]
    return state0, losses, {k: np.asarray(v) for k, v in jax.device_get(tr.state.params).items()}


@pytest.fixture(scope="module")
def jax_runs():
    return {(name, shape): _jax_run(name, *SHAPES[shape]) for name in CONFIGS
            for shape in SHAPES}


@pytest.fixture(scope="module")
def states(jax_runs, tmp_path_factory):
    """The JAX init of each config, as the port's TrainState on disk."""
    d = tmp_path_factory.mktemp("states")
    paths = {}
    for name in CONFIGS:
        st = convert.train_state_from_numpy(jax_runs[(name, "dp2")][0], device="cpu")
        paths[name] = str(d / f"{name}.pt")
        torch.save(st, paths[name])
    return paths


def _port(states, d, m, tmp):
    return run_ranks(d * m, {"kind": "train", "base": BASE, "configs": CONFIGS, "data": d,
                             "model": m, "steps": STEPS, "state": states}, tmp)


@pytest.fixture(scope="module")
def port_runs(states, tmp_path_factory):
    return {shape: _port(states, *SHAPES[shape], tmp_path_factory.mktemp(shape))
            for shape in SHAPES}


@pytest.fixture(scope="module")
def one_rank(states, tmp_path_factory):
    return _port(states, 1, 1, tmp_path_factory.mktemp("one"))[0]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_one_rank_grid_is_bitwise_the_single_device_trainer(name, one_rank, states):
    cfg = CrossCoderConfig(**{**BASE, **CONFIGS[name]})
    tr = Trainer(cfg, SyntheticActivationSource(cfg), device="cpu",
                 state=torch.load(states[name], weights_only=False))
    assert tr.mesh is None
    losses = [float(tr.step()["loss"]) for _ in range(STEPS)]
    got = one_rank[name]
    assert [s["loss"] for s in got["steps"]] == losses
    for k, v in tr.state.params.items():
        np.testing.assert_array_equal(got["params"][k], v.float().numpy(), err_msg=k)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_mesh_trainer_matches_the_jax_mesh_trainer(name, shape, jax_runs, port_runs):
    _, jlosses, jparams = jax_runs[(name, shape)]
    for rank, res in enumerate(port_runs[shape]):
        got = res[name]
        np.testing.assert_allclose([s["loss"] for s in got["steps"]], jlosses, rtol=RTOL,
                                   atol=ATOL)
        for k, v in jparams.items():
            np.testing.assert_allclose(got["params"][k], v.astype(np.float32), rtol=RTOL,
                                       atol=ATOL, err_msg=f"rank {rank} {k}")


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_mesh_trainer_matches_its_one_rank_run(name, shape, port_runs, one_rank):
    got, want = port_runs[shape][0][name], one_rank[name]
    np.testing.assert_allclose([s["loss"] for s in got["steps"]],
                               [s["loss"] for s in want["steps"]], rtol=RTOL, atol=ATOL)
    for k, v in want["params"].items():
        np.testing.assert_allclose(got["params"][k], v, rtol=RTOL, atol=ATOL, err_msg=k)
    for key in ("l2_loss", "l0_loss", "explained_variance", "dead_frac"):
        if key in want["steps"][0]:
            np.testing.assert_allclose(got["steps"][0][key], want["steps"][0][key],
                                       rtol=RTOL, atol=ATOL, err_msg=key)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_step0_selects_the_jax_encoders_active_latents(name, shape, jax_runs, port_runs):
    state0 = jax_runs[(name, shape)][0]
    cfg = _jcfg(name)
    x = JSource(cfg).next()
    f = np.asarray(jcc.encode(state0.params, x, cfg))
    h = np.asarray(jcc.encode(state0.params, x, cfg, apply_activation=False))
    # distinct positive values: the selection has no tie to break
    pos = h[h > 0]
    assert len(np.unique(pos)) == pos.size
    np.testing.assert_array_equal(port_runs[shape][0][name]["active"], f > 0)


def test_torchrun_main_logs_and_writes_from_the_primary_only(tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    ckpt = tmp_path / "ckpt"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
           "--master-port", str(__import__("_torch_parallel_child").free_port()),
           "-m", "crosscoder_tpu_torch.train.main", "--device", "cpu",
           "--data-source", "synthetic", "--d-in", "16", "--dict-size", "64",
           "--batch-size", "16", "--num-tokens", "64", "--log-every", "1",
           "--log-backend", "jsonl", "--checkpoint-dir", str(ckpt), "--save-every", "2"]
    out = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "multihost: {'process_index': 0, 'process_count': 2" in out.stderr
    vdirs = sorted(p for p in ckpt.iterdir() if p.name.startswith("version_"))
    assert [p.name for p in vdirs] == ["version_0"]
    logs = list(ckpt.rglob("metrics.jsonl"))
    assert len(logs) == 1
    rows = [json.loads(line) for line in logs[0].read_text().splitlines()]
    assert [r["step"] for r in rows] == [0, 1, 2, 3]
    assert sorted(int(p.name.split("_")[0]) for p in vdirs[0].glob("*_meta.json")) == [0, 1, 2]
