"""The telemetry plane and the resilience hooks on the card. Every test
needs a CUDA device and skips without one; the file imports no JAX:

    python -m pytest -m cuda tests/test_torch_obs_cuda.py

- obs on is bitwise obs off (losses, state) with every kernel launched as
  often (TopK with the sparse backward: K5, K8, K10, O1), prefetch on;
- a profiler window's Chrome trace names the port's kernels (K5's
  ``topk_slice_kernel``, K8's ``sparsify_*_kernel`` on either route, K10's
  ``scatter_rows_kernel``, O1's ``adam_update_kernel``) beside the host
  spans, and the memory gauges read the card (the limit its total);
- the watchdog's runner launches on the calling thread's stream: a watched
  serve on the prefetch worker copies on the worker's stream, bitwise the
  unwatched run;
- ``poison_batch`` on a device store's serve writes a copy: the store's
  rows stay finite while the poisoned step's loss is not.

Bars: bitwise."""

import json

import numpy as np
import pytest
import torch

from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.data import buffer as buf
from crosscoder_tpu_torch.models import lm
from crosscoder_tpu_torch.ops import adam
from crosscoder_tpu_torch.ops import sparse_grad as sg
from crosscoder_tpu_torch.ops import topk_pallas as tp
from crosscoder_tpu_torch.resilience import Chaos, Watchdog
from crosscoder_tpu_torch.train import trainer as trainer_mod
from crosscoder_tpu_torch.utils.logging import MetricsLogger

pytestmark = pytest.mark.cuda

TOPK = dict(d_in=256, dict_size=4096, batch_size=1024, activation="topk", topk_k=16,
            l1_coeff=0.0, sparse_bwd="on", aux_k=32, aux_every=2, aux_dead_steps=2)
KERNELS = {"K5": "topk_slice_kernel", "K8": "sparsify_",
           "K10": "scatter_rows_kernel", "O1": "adam_update_kernel"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _counters():
    return {"K5": tp.topk, "K8": tp.sparsify, "K10": sg.scatter_add_rows, "O1": adam.adam_update}


def _same_state(a, b):
    for x, y in ((a.params, b.params), (a.opt_state.mu, b.opt_state.mu),
                 (a.opt_state.nu, b.opt_state.nu), (a.aux or {}, b.aux or {})):
        for k in x:
            assert torch.equal(x[k], y[k]), k


def test_obs_on_is_bitwise_off_with_the_same_launches(cuda, tmp_path):
    runs = {}
    for obs in ("off", "on"):
        cfg = CrossCoderConfig(**TOPK, obs=obs, log_backend="null",
                               checkpoint_dir=str(tmp_path / obs))
        tr = trainer_mod.Trainer(cfg, device="cuda")
        counters = _counters()
        for c in counters.values():
            c.launches = 0
        losses = [float(tr.step(full_metrics=i % 2 == 0)["loss"]) for i in range(6)]
        tr.close()
        runs[obs] = (losses, tr.state, {k: c.launches for k, c in counters.items()})
    assert runs["on"][0] == runs["off"][0]
    _same_state(runs["on"][1], runs["off"][1])
    assert runs["on"][2] == runs["off"][2] and all(runs["on"][2].values()), runs["on"][2]


def test_profiler_window_names_the_ports_kernels(cuda, tmp_path):
    cfg = CrossCoderConfig(**TOPK, obs="on", profile_steps="1:3", log_every=1,
                           log_backend="jsonl", checkpoint_dir=str(tmp_path),
                           num_tokens=1024 * 5)
    tr = trainer_mod.Trainer(cfg, device="cuda", logger=MetricsLogger(cfg))
    tr.train()
    (path,) = (tmp_path / "obs" / "profile").iterdir()
    assert path.name == "window0_steps_1-2.trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    for k, sym in KERNELS.items():
        assert any(sym in n for n in kernels), (k, sorted(kernels)[:40])
    names = {e.get("name") for e in events}
    assert {"step", "refill_wait"} <= names
    rec = json.loads((tmp_path / "metrics.jsonl").read_text().splitlines()[-1])
    assert rec["perf/hbm_bytes_limit"] == torch.cuda.mem_get_info()[1]
    assert 0 < rec["perf/hbm_bytes_in_use"] <= rec["perf/hbm_peak_bytes"]
    assert rec["perf/profile_windows"] == 1


def test_watchdog_runner_launches_on_the_callers_stream(cuda, monkeypatch):
    s = torch.cuda.Stream()
    with torch.cuda.stream(s):
        got = Watchdog(5.0).call(lambda: torch.cuda.current_stream().cuda_stream)
    assert got == s.cuda_stream != torch.cuda.current_stream().cuda_stream
    runs = {}
    for timeout in (0.0, 5.0):
        copies = []
        real = trainer_mod.to_device

        def to_device(b, device):
            copies.append(torch.cuda.current_stream(device).cuda_stream)
            return real(b, device)

        monkeypatch.setattr(trainer_mod, "to_device", to_device)
        serve_streams = []
        cfg = CrossCoderConfig(**TOPK, log_backend="null", harvest_timeout_s=timeout,
                               chaos="fail@2", harvest_backoff_s=0.01)
        tr = trainer_mod.Trainer(cfg, device="cuda",
                                 chaos=Chaos.parse("fail@2") if timeout else None)
        real_serve = tr._serve_staged

        def serve(*a, **k):
            serve_streams.append(torch.cuda.current_stream().cuda_stream)
            return real_serve(*a, **k)

        tr._serve_staged = serve
        losses = [float(tr.step()["loss"]) for _ in range(5)]
        worker = tr._copy_stream.cuda_stream
        tr.close()
        monkeypatch.setattr(trainer_mod, "to_device", real)
        runs[timeout] = (losses, tr.state)
        assert copies and all(c == worker for c in copies), (copies, worker)
        assert serve_streams and all(c == worker for c in serve_streams)
        if timeout:
            assert tr.resilience.snapshot() == {"resilience/harvest_retries": 1}
    assert runs[5.0][0] == runs[0.0][0]
    _same_state(runs[5.0][1], runs[0.0][1])


def test_poison_batch_writes_a_copy_of_a_device_stores_serve(cuda):
    lm_cfg = lm.LMConfig.tiny()
    params = [lm.init_params(lm_cfg, seed=s, device="cuda") for s in (0, 1)]
    tokens = np.random.default_rng(7).integers(0, 257, size=(256, 17), dtype=np.int64)
    cfg = CrossCoderConfig(batch_size=64, buffer_mult=8, seq_len=17, d_in=32, n_models=2,
                           model_batch_size=4, norm_calib_batches=2, buffer_device="hbm",
                           hook_point="blocks.2.hook_resid_pre", seed=3, dict_size=256,
                           activation="batchtopk", topk_k=8, l1_coeff=0.0, log_backend="null")
    chaos = Chaos.parse("nan@1")
    b = buf.make_buffer(cfg, lm_cfg, params, tokens, device="cuda")
    assert b.store_device.type == "cuda"
    tr = trainer_mod.Trainer(cfg, b, device="cuda", chaos=chaos)
    losses = []
    for _ in range(3):
        losses.append(float(tr.step()["loss"]))
        assert all(torch.isfinite(t.float()).all() for t in b._store_tensors())
    tr.close()
    assert np.isfinite(losses[0]) and not np.isfinite(losses[1])
