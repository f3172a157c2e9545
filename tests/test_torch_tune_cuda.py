"""The tuner on the card: the step-identity gate over the kernels' step (K5,
K8, K10 and O1 in the TopK step with the sparse backward and AuxK), and a
calibration window through the Trainer on ``cuda``. Every test needs a
CUDA device and skips without one; the file imports no JAX:

    python -m pytest -m cuda tests/test_torch_tune_cuda.py

Bars: bitwise (the gate); the window's keys and its scoring rule."""

import pytest
import torch

from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.tune import calibrate, lattice

pytestmark = pytest.mark.cuda

SMALL = dict(d_in=256, dict_size=4096, batch_size=1024, activation="topk", topk_k=16,
             l1_coeff=0.0, sparse_bwd="on", aux_k=32, aux_every=2, aux_dead_steps=2,
             enc_dtype="bf16", master_dtype="fp32", log_backend="null")
KERNELS = ("topk_mask", "sparsify", "scatter_add_rows", "adam_update")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.parametrize("knobs", [
    {"prefetch": False, "refill_frac": 0.25},
    {"refill_overlap": "on", "refill_dispatch_batch": 8, "prefetch": True},
], ids=["prefetch_off", "overlap_on"])
def test_gate_passes_data_plane_knobs_bitwise_on_the_card(cuda, knobs):
    counters = calibrate.kernel_counters()
    before = {k: counters[k].launches for k in KERNELS}
    ok, findings = calibrate.step_identity_gate(CrossCoderConfig(**SMALL, **knobs), knobs,
                                                device="cuda")
    assert ok, findings
    # both steps launched the step's kernels (the AuxK step scatters twice)
    launched = {k: counters[k].launches - before[k] for k in KERNELS}
    assert launched == {"topk_mask": 2, "sparsify": 2, "scatter_add_rows": 4,
                        "adam_update": 2}, launched


def test_gate_rejects_a_smuggled_step_knob_on_the_card(cuda, monkeypatch):
    monkeypatch.setattr(lattice, "STEP_FIELDS", lattice.STEP_FIELDS - {"topk_k"})
    ok, findings = calibrate.step_identity_gate(CrossCoderConfig(**SMALL), {"topk_k": 16},
                                                device="cuda")
    assert not ok and any("loss" in f for f in findings), findings


def test_measure_window_on_the_card(cuda):
    counters = calibrate.kernel_counters()
    before = counters["adam_update"].launches
    m = calibrate.measure_window(CrossCoderConfig(**SMALL), steps=3, warmup=1, device="cuda")
    assert counters["adam_update"].launches - before == 4
    assert {"step_ms", "bubble_frac", "effective_step_ms", "acts_per_sec_chip", "wall_s",
            "steps", "score", "wall_step_ms", "scored_on"} == set(m)
    assert m["score"] == pytest.approx(SMALL["batch_size"] * 1e3 / m["effective_step_ms"])
    if m["scored_on"] == "wall":
        assert m["effective_step_ms"] == m["wall_step_ms"]
    else:
        assert abs(m["step_ms"] - m["wall_step_ms"]) <= 0.1 * m["wall_step_ms"]
