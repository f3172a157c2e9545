"""The trainer's one-deep prefetch on the card: the batch's copy runs on
the worker's CUDA stream, not the step's, from page-locked host memory
(the synthetic source's staging, the host store's rows), and the run is bitwise the run with prefetch off (losses and state), over the
synthetic source (TopK, sparse backward: K5, K8, K10, O1) and over a host
bf16 store of two tiny LMs (BatchTopK: K9, O1). Every test needs a CUDA
device and skips without one; the file imports no JAX:

    python -m pytest -m cuda tests/test_torch_prefetch_cuda.py

Bars: bitwise."""

import numpy as np
import pytest
import torch

from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.data import buffer as buf
from crosscoder_tpu_torch.data.synthetic import SyntheticActivationSource
from crosscoder_tpu_torch.models import lm
from crosscoder_tpu_torch.train import trainer as trainer_mod

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _run(cfg, src, monkeypatch, steps=6):
    """``steps`` steps; the losses, the state and, per copy, its stream and
    whether it left page-locked memory."""
    copies = []
    real = trainer_mod.to_device

    def to_device(b, device):
        pinned = torch.is_tensor(b) and b.device.type == "cpu" and b.is_pinned()
        copies.append((torch.cuda.current_stream(device).cuda_stream, pinned))
        return real(b, device)

    monkeypatch.setattr(trainer_mod, "to_device", to_device)
    tr = trainer_mod.Trainer(cfg, src, device="cuda")
    losses = [float(tr.step()["loss"]) for _ in range(steps)]
    main = torch.cuda.current_stream().cuda_stream
    tr.close()
    monkeypatch.setattr(trainer_mod, "to_device", real)
    return losses, tr.state, copies, main


def _same_state(a, b):
    for x, y in ((a.params, b.params), (a.opt_state.mu, b.opt_state.mu),
                 (a.opt_state.nu, b.opt_state.nu), (a.aux or {}, b.aux or {})):
        for k in x:
            assert torch.equal(x[k], y[k]), k


def _check(runs):
    (l_on, s_on, c_on, main), (l_off, s_off, c_off, _) = runs[True], runs[False]
    assert l_on == l_off
    _same_state(s_on, s_off)
    assert c_on and all(s != main and pinned for s, pinned in c_on), (c_on, main)
    assert all(s == main for s, _ in c_off)


def test_prefetch_copies_on_its_own_stream_bitwise_off_synthetic(cuda, monkeypatch):
    runs = {}
    for pf in (True, False):
        cfg = CrossCoderConfig(d_in=256, dict_size=4096, batch_size=1024, activation="topk",
                               topk_k=16, l1_coeff=0.0, sparse_bwd="on", aux_k=32, aux_every=2,
                               aux_dead_steps=2, log_backend="null", prefetch=pf)
        runs[pf] = _run(cfg, SyntheticActivationSource(cfg), monkeypatch)
    _check(runs)


def test_prefetch_copies_on_its_own_stream_bitwise_off_host_store(cuda, monkeypatch):
    lm_cfg = lm.LMConfig.tiny()
    params = [lm.init_params(lm_cfg, seed=s, device="cuda") for s in (0, 1)]
    tokens = np.random.default_rng(7).integers(0, 257, size=(256, 17), dtype=np.int64)
    runs = {}
    for pf in (True, False):
        cfg = CrossCoderConfig(batch_size=64, buffer_mult=8, seq_len=17, d_in=32, n_models=2,
                               model_batch_size=4, norm_calib_batches=2,
                               hook_point="blocks.2.hook_resid_pre", seed=3, dict_size=256,
                               activation="batchtopk", topk_k=8, l1_coeff=0.0,
                               log_backend="null", prefetch=pf)
        b = buf.make_buffer(cfg, lm_cfg, params, tokens, device="cuda")
        assert b.store_device.type == "cpu"
        runs[pf] = _run(cfg, b, monkeypatch)
    _check(runs)
