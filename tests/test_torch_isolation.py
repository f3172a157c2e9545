"""The port stands alone: no file of crosscoder_tpu_torch/ nor chip_smoke.py
imports jax or the JAX package; entry points refuse to fall back to the CPU
when no device is named and CUDA is absent; a CPU run launches no kernel."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from crosscoder_tpu_torch import convert, demo, eval_ce, replicate
from crosscoder_tpu_torch.checkpoint import Checkpointer, torch_compat
from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.data.buffer import make_buffer
from crosscoder_tpu_torch.models import crosscoder, lm
from crosscoder_tpu_torch.ops import adam
from crosscoder_tpu_torch.ops import fused_encoder_topk as fek
from crosscoder_tpu_torch.ops import paged_attention as pa
from crosscoder_tpu_torch.ops import quant, sparse_grad, topk_pallas
from crosscoder_tpu_torch.resilience import elastic_drill
from crosscoder_tpu_torch.serve import InferenceEngine
from crosscoder_tpu_torch.serve.smoke import build_engine, serve_batch
from crosscoder_tpu_torch.train import main as train_main
from crosscoder_tpu_torch.train.fleet import FleetScheduler
from crosscoder_tpu_torch.train.state import Optimizer, init_train_state
from crosscoder_tpu_torch.train.trainer import Trainer

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "crosscoder_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_checkpoint_subpackage_is_checked():
    names = {str(p.relative_to(ROOT)) for p in FILES}
    assert {"crosscoder_tpu_torch/checkpoint/__init__.py", "crosscoder_tpu_torch/checkpoint/ckpt.py",
            "crosscoder_tpu_torch/checkpoint/torch_compat.py"} <= names


def test_fleet_modules_are_checked():
    names = {str(p.relative_to(ROOT)) for p in FILES}
    assert {"crosscoder_tpu_torch/train/fleet.py", "crosscoder_tpu_torch/models/stacked.py",
            "crosscoder_tpu_torch/data/fanout.py"} <= names


def test_obs_and_resilience_modules_are_checked():
    names = {str(p.relative_to(ROOT)) for p in FILES}
    assert {"crosscoder_tpu_torch/obs/__init__.py", "crosscoder_tpu_torch/obs/trace.py",
            "crosscoder_tpu_torch/obs/profiler.py", "crosscoder_tpu_torch/resilience/chaos.py",
            "crosscoder_tpu_torch/resilience/watchdog.py"} <= names


def test_compile_tier_modules_are_checked():
    names = {str(p.relative_to(ROOT)) for p in FILES}
    assert {"crosscoder_tpu_torch/utils/compile_cache.py", "crosscoder_tpu_torch/ops/_build.py",
            "crosscoder_tpu_torch/serve/warm_start.py"} <= names


def test_elastic_modules_are_checked():
    names = {str(p.relative_to(ROOT)) for p in FILES}
    assert {"crosscoder_tpu_torch/resilience/elastic.py",
            "crosscoder_tpu_torch/resilience/elastic_drill.py",
            "crosscoder_tpu_torch/resilience/fleet.py",
            "crosscoder_tpu_torch/parallel/multihost.py"} <= names


def test_tune_modules_are_checked():
    names = {str(p.relative_to(ROOT)) for p in FILES}
    assert {f"crosscoder_tpu_torch/tune/{m}.py" for m in (
        "__init__", "artifact", "lattice", "calibrate", "autotune", "smoke", "report")} <= names


def test_contracts_modules_are_checked():
    names = {str(p.relative_to(ROOT)) for p in FILES}
    assert {f"crosscoder_tpu_torch/analysis/contracts/{m}.py" for m in (
        "__init__", "__main__", "engine", "ast_lints", "cache_keys", "step_rules",
        "kernel_safety", "mutations")} <= names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_import(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "crosscoder_tpu")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_default_device_raises_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = CrossCoderConfig(d_in=32, dict_size=64, serve="on", serve_max_batch=2)
    tcfg = CrossCoderConfig(d_in=32, dict_size=64, log_backend="null")
    tr = Trainer(tcfg, device="cpu", checkpointer=Checkpointer(base_dir=tmp_path))
    tr.save()
    vdir = Checkpointer.latest_version_dir(tmp_path)
    for call in (lambda: lm.init_params(lm.LMConfig.tiny()),
                 lambda: crosscoder.init_params(cfg),
                 lambda: convert.lm_params_from_numpy({"embed": np.zeros((2, 2), np.float32)}),
                 lambda: convert.crosscoder_params_from_numpy({"b_enc": np.zeros(2, np.float32)}),
                 lambda: InferenceEngine(cfg, lm.LMConfig.tiny(), [], {"W_enc": torch.zeros(1)}),
                 lambda: build_engine(),
                 lambda: Trainer(cfg),
                 lambda: init_train_state(cfg, Optimizer(cfg, lambda s: 0.0)),
                 lambda: convert.train_state_from_numpy(None),
                 lambda: train_main.main(["--data-source", "synthetic", "--d-in", "32",
                                          "--dict-size", "64", "--log-backend", "null"]),
                 lambda: make_buffer(CrossCoderConfig(seq_len=17, d_in=32), lm.LMConfig.tiny(),
                                     [{}, {}], np.zeros((8, 17), np.int64)),
                 lambda: torch_compat.params_from_torch_state_dict(
                     {n: torch.zeros(1) for n in ("W_enc", "W_dec", "b_enc", "b_dec")}, cfg),
                 lambda: Checkpointer.load_weights(vdir),
                 lambda: lm.from_torch_state_dict({}, lm.LMConfig.tiny()),
                 lambda: lm.from_hf(str(tmp_path)),
                 lambda: demo.train_tiny_lm(0, lm.LMConfig.tiny(), np.zeros((16, 4), np.int64), 1),
                 lambda: replicate.main(["--demo", "--out", str(tmp_path / "replicate")]),
                 lambda: eval_ce.main(["--demo"]),
                 lambda: Checkpointer(base_dir=tmp_path).restore(tcfg),
                 lambda: FleetScheduler(tcfg.replace(fleet="on", fleet_tenants="a;b")),
                 lambda: elastic_drill.run_autoscale_drill(workdir=str(tmp_path / "drill"))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_cpu_run_launches_no_kernel():
    counters = (pa.paged_attention, fek.fused_topk_encode, topk_pallas.topk,
                topk_pallas.topk_mask_f32, topk_pallas.topk_chunked,
                topk_pallas.sparsify, sparse_grad.scatter_add_rows,
                topk_pallas.batchtopk_select, topk_pallas.batchtopk_emit, quant.quantize_rows,
                fek.fused_topk_encode_q, fek.fused_batchtopk_select, fek.fused_batchtopk_emit,
                adam.adam_update)
    for c in counters:
        c.launches = 0
    eng, _, lm_cfg, _, _ = build_engine(device="cpu")
    rng = np.random.default_rng(0)
    res = serve_batch(eng, [rng.integers(1, lm_cfg.vocab_size, size=n, dtype=np.int32)
                            for n in (3, 16, 9)])
    assert len(res) == 3
    tcfg = CrossCoderConfig(d_in=32, dict_size=256, batch_size=16, activation="topk",
                            topk_k=8, l1_coeff=0.0, sparse_bwd="on", aux_k=16,
                            aux_dead_steps=1, log_backend="null")
    tr = Trainer(tcfg, device="cpu")
    for _ in range(3):
        assert torch.isfinite(tr.step()["loss"])
    # the f32 TopK routes: K6 (dict 256) and K7 (dict 2^15)
    for dict_size in (256, 2 ** 15):
        tr = Trainer(tcfg.replace(enc_dtype="fp32", dict_size=dict_size, d_in=8), device="cpu")
        assert torch.isfinite(tr.step()["loss"])
    assert topk_pallas.topk(torch.ones((2, 2 ** 17), dtype=torch.bfloat16), 4).sum() == 8
    # the fused tiers: int8 TopK (K3) and BatchTopK (K4), AuxK steps between
    for kw in (dict(fused_encoder="on", quant_encoder=True, quant_block=128, d_in=64),
               dict(activation="batchtopk", sparse_bwd="auto", fused_encoder="on", aux_every=2)):
        tr = Trainer(tcfg.replace(**kw), device="cpu")
        for _ in range(3):
            assert torch.isfinite(tr.step()["loss"])
    # the harvest-train path: tiny LM, int8 buffer on the device store, BatchTopK
    lm_params = [lm.init_params(lm.LMConfig.tiny(), seed=s, device="cpu") for s in (0, 1)]
    bcfg = CrossCoderConfig(d_in=32, dict_size=128, batch_size=16, buffer_mult=16, seq_len=17,
                            norm_calib_batches=1, hook_point="blocks.2.hook_resid_pre",
                            activation="batchtopk", topk_k=4, l1_coeff=0.0, quant_buffer=True,
                            quant_block=16, buffer_device="hbm", log_backend="null")
    b = make_buffer(bcfg, lm.LMConfig.tiny(), lm_params,
                    rng.integers(1, 257, size=(40, 17)), device="cpu")
    tr = Trainer(bcfg, b, device="cpu")
    for _ in range(10):                                  # crosses refills
        assert torch.isfinite(tr.step()["loss"])
    tr._drain_prefetch()        # its worker's serve in flight lands before the next server's
    tr = Trainer(bcfg.replace(fused_encoder="on"), b, device="cpu")   # K4 over the harvest
    for _ in range(3):
        assert torch.isfinite(tr.step()["loss"])
    # the fleet: a cohort (TopK, sparse tier) and a bucket (BatchTopK)
    fl = FleetScheduler(tcfg.replace(fleet="on", fleet_tenants=(
        "a:seed=1;b:seed=2;w:activation=batchtopk,sparse_bwd=auto,dict_size=128")),
        checkpoint=False, device="cpu")
    for _ in range(2):
        assert all(torch.isfinite(m["loss"]) for m in fl.step_all().values())
    assert all(c.launches == 0 for c in counters)
    assert adam.adam_update.cohort_launches == 0
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        pa.paged_attention(*(torch.zeros(1, 4, 2, 8, device="meta") for _ in range(3)),
                           torch.ones(1), page_size=4, scale=1.0)
