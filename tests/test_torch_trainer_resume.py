"""The port's Trainer across checkpoints, and the Trainer on the f32 TopK
routes: ``train.main --resume`` continues a run; a SIGTERM mid-``train()``
leaves a save that resumes to the straight run's bits; a TopK trainer at
f32 on the K6 route (dict 1024) and on the K7 route (dict 2^15) follows
the JAX Trainer within the Lyapunov bar of tests/test_torch_trainer.py
(twice a control trainer's divergence from a 1e-6 relative W_enc
perturbation, plus 1e-6·|loss|), the JAX side with its kernels in
interpret mode."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crosscoder_tpu.config import CrossCoderConfig as JCfg
from crosscoder_tpu.data.synthetic import SyntheticActivationSource as JSource
from crosscoder_tpu.ops import fused_encoder_topk as jfek
from crosscoder_tpu.ops import sparse_grad as jsg
from crosscoder_tpu.ops import topk_pallas as jtp
from crosscoder_tpu.parallel import mesh as jmesh
from crosscoder_tpu.train import trainer as jtrainer
from crosscoder_tpu_torch import convert
from crosscoder_tpu_torch.checkpoint import Checkpointer
from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.data.synthetic import SyntheticActivationSource
from crosscoder_tpu_torch.ops import topk_pallas
from crosscoder_tpu_torch.train import main as tmain
from crosscoder_tpu_torch.train.trainer import Trainer

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--data-source", "synthetic", "--d-in", "32", "--dict-size", "256", "--batch-size", "16",
        "--activation", "topk", "--topk-k", "8", "--l1-coeff", "0", "--sparse-bwd", "on",
        "--aux-k", "16", "--aux-every", "2", "--log-every", "2", "--log-print-every", "0",
        "--save-every", "4"]


def _params(state):
    return {k: v.clone() for k, v in state.params.items()}


def test_main_resume_continues_a_run(tmp_path):
    d = str(tmp_path)
    first = tmain.main(ARGS + ["--num-tokens", "96", "--log-backend", "jsonl",
                               "--checkpoint-dir", d], device="cpu")
    assert first.state.step == 6
    vdir = tmp_path / "version_0"
    assert Checkpointer.complete_saves(vdir) == [0, 1]          # step 4 (save_every), end
    assert json.loads((vdir / "1_meta.json").read_text())["step"] == 6
    second = tmain.main(ARGS + ["--num-tokens", "160", "--log-backend", "jsonl",
                                "--checkpoint-dir", d, "--resume", "true"], device="cpu")
    assert second.state.step == 10 and second.buffer.counter == 10
    assert [json.loads((vdir / f"{v}_meta.json").read_text())["step"]
            for v in Checkpointer.complete_saves(vdir)] == [4, 6, 8, 10]
    rows = [json.loads(x) for x in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [0, 2, 4, 6, 8]
    assert all(np.isfinite(r["loss"]) for r in rows)
    # the resumed run started from the first run's last state
    state, meta = Checkpointer(base_dir=tmp_path).restore(
        CrossCoderConfig.from_json(vdir / "1_cfg.json"), version_dir=vdir, save=1, device="cpu")
    for k, v in first.state.params.items():
        assert torch.equal(state.params[k], v)


SIGTERM_CHILD = textwrap.dedent("""
    import os, signal, sys
    from crosscoder_tpu_torch.data import synthetic
    from crosscoder_tpu_torch.train import main

    served = synthetic.SyntheticActivationSource.next

    def next_(self):
        if self.counter == 3:
            os.kill(os.getpid(), signal.SIGTERM)     # preempted while serving step 3
        return served(self)

    synthetic.SyntheticActivationSource.next = next_
    tr = main.main(sys.argv[1:], device="cpu")
    print("STOPPED_AT", tr.state.step)
""")


def test_sigterm_mid_train_leaves_a_resumable_save(tmp_path):
    # the source signals from inside its serve of step 3: serving inline, so
    # the serve is step 3's (with the prefetch it runs a step ahead on the
    # worker: tests/test_torch_prefetch.py holds that case)
    args = ARGS + ["--num-tokens", "160", "--save-every", "100", "--log-backend", "null",
                   "--prefetch", "false"]
    proc = subprocess.run([sys.executable, "-c", SIGTERM_CHILD, *args, "--checkpoint-dir",
                           str(tmp_path / "a")], capture_output=True, text=True, timeout=300,
                          cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "STOPPED_AT 4" in proc.stdout and "SIGTERM: stopping" in proc.stderr
    vdir = tmp_path / "a" / "version_0"
    assert Checkpointer.complete_saves(vdir) == [0]
    assert json.loads((vdir / "0_meta.json").read_text())["step"] == 4
    cfg = CrossCoderConfig.from_cli(args + ["--checkpoint-dir", str(tmp_path / "a"),
                                            "--resume", "true"])
    resumed = Trainer(cfg, SyntheticActivationSource(cfg), device="cpu",
                      checkpointer=Checkpointer(cfg=cfg))
    assert resumed.step_counter == 4 and resumed.buffer.counter == 4
    resumed.train()
    straight = tmain.main(args + ["--checkpoint-dir", str(tmp_path / "b")], device="cpu")
    assert resumed.state.step == straight.state.step == 10
    for k, v in straight.state.params.items():
        assert torch.equal(resumed.state.params[k], v), k
    assert torch.equal(resumed.state.aux["steps_since_fired"],
                       straight.state.aux["steps_since_fired"])


def test_second_sigterm_falls_through(tmp_path):
    """The handler is installed only inside train(); a second SIGTERM hands
    the signal back to the previous handler."""
    import signal

    seen = []
    prev = signal.signal(signal.SIGTERM, lambda s, f: seen.append(s))
    try:
        # two signals from the serve on the main thread, each handled apart
        # (from the prefetch worker they could reach the handler as one)
        cfg = CrossCoderConfig.from_cli(ARGS + ["--num-tokens", "96", "--log-backend", "null",
                                                "--checkpoint-dir", str(tmp_path),
                                                "--prefetch", "false"])

        class Twice(SyntheticActivationSource):
            def next(self):
                if self.counter == 1:
                    os.kill(os.getpid(), signal.SIGTERM)
                    os.kill(os.getpid(), signal.SIGTERM)
                return super().next()

        tr = Trainer(cfg, Twice(cfg), device="cpu", checkpointer=Checkpointer(cfg=cfg))
        tr.train()
        assert seen == [signal.SIGTERM] and tr.state.step == 2
        assert signal.getsignal(signal.SIGTERM) is not None
        assert json.loads((tmp_path / "version_0" / "0_meta.json").read_text())["step"] == 2
    finally:
        signal.signal(signal.SIGTERM, prev)


def test_second_sigterm_falls_through_with_the_prefetch_on(tmp_path):
    """The same two signals with the prefetch on (the default), sent from
    the main thread before step 1 while the worker is serving: the first
    stops the loop after that step, the second reaches the previous
    handler, and the save records the stream before the batch in flight."""
    import signal

    seen = []
    prev = signal.signal(signal.SIGTERM, lambda s, f: seen.append(s))
    try:
        cfg = CrossCoderConfig.from_cli(ARGS + ["--num-tokens", "96", "--log-backend", "null",
                                                "--checkpoint-dir", str(tmp_path)])
        assert cfg.prefetch

        class Twice(Trainer):
            def step(self, full_metrics=True):
                if self._host_step == 1:
                    os.kill(os.getpid(), signal.SIGTERM)
                    os.kill(os.getpid(), signal.SIGTERM)
                return super().step(full_metrics)

        tr = Twice(cfg, SyntheticActivationSource(cfg), device="cpu",
                   checkpointer=Checkpointer(cfg=cfg))
        tr.train()
        assert seen == [signal.SIGTERM] and tr.state.step == 2
        assert signal.getsignal(signal.SIGTERM) is not None
        meta = json.loads((tmp_path / "version_0" / "0_meta.json").read_text())
        assert meta["step"] == 2 and meta["buffer"]["counter"] == 2
    finally:
        signal.signal(signal.SIGTERM, prev)


# ---------------------------------------------------------------------------
# the f32 TopK routes against the JAX Trainer

STEPS = 5


@pytest.fixture
def _interpret_kernels():
    for m in (jtp, jsg, jfek):
        m.set_interpret(True)
    yield
    for m in (jtp, jsg, jfek):
        m.set_interpret(False)


def _jax_trainer(kw, perturb=None):
    cfg = JCfg(**kw)
    tr = jtrainer.Trainer(cfg, JSource(cfg), mesh=jmesh.make_mesh(devices=jax.devices()[:1]))
    if perturb is not None:
        p = dict(tr.state.params)
        p["W_enc"] = jnp.asarray(np.asarray(p["W_enc"]) * (1 + perturb))
        tr.state = jax.device_put(tr.state._replace(params=p), tr._state_shardings)
    return tr


@pytest.mark.parametrize("d_in,dict_size,k,route", [(64, 1024, 16, "K6"), (8, 2 ** 15, 4, "K7")])
def test_f32_topk_trainer_follows_jax_within_lyapunov_control(_interpret_kernels, d_in,
                                                              dict_size, k, route):
    kw = dict(d_in=d_in, n_models=2, dict_size=dict_size, batch_size=8, num_tokens=8 * STEPS,
              enc_dtype="fp32", log_backend="null", prefetch=False, seed=5, lr=5e-3,
              dec_init_norm=0.5, activation="topk", topk_k=k, l1_coeff=0.0, sparse_bwd="on",
              fused_encoder="off")
    assert topk_pallas.topk_route(dict_size, k, torch.float32) == route
    probe = jax.ShapeDtypeStruct((1, dict_size), jnp.float32)
    assert jtp.supported(probe, k) and not jtp._composite_supported(probe, k)
    assert jtp._single_block_supported(dict_size, k, 4) == (route == "K6")
    jtr = _jax_trainer(kw)
    cfg = CrossCoderConfig(**kw)
    tr = Trainer(cfg, SyntheticActivationSource(cfg), device="cpu",
                 state=convert.train_state_from_numpy(jax.device_get(jtr.state), device="cpu"))
    noise = np.random.default_rng(11).standard_normal((2, d_in, dict_size)).astype(np.float32)
    ctl = _jax_trainer(kw, perturb=noise * 1e-6)
    want = np.array([float(jtr.step()["loss"]) for _ in range(STEPS)])
    got = np.array([float(tr.step()["loss"]) for _ in range(STEPS)])
    control = np.array([float(ctl.step()["loss"]) for _ in range(STEPS)])
    jtr.close()
    ctl.close()
    assert np.isfinite(got).all()
    bar = 2 * np.abs(control - want) + 1e-6 * np.abs(want)
    assert (np.abs(got - want) <= bar).all(), (got - want, bar)
