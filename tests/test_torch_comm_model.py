"""The counted wire (``crosscoder_tpu_torch/parallel/comm_model.py`` over
the byte counts of ``parallel/collectives.py``) on the CPU:

- (a) ``profile_width``'s fake group counts, by op and exactly, what real
  gloo ranks running the same program count (``train_dp`` and
  ``train_dp_quant`` at widths 2, 4 and 8, ``train_dp_tp`` at 2 × 2; one
  8-rank launch for the file, the ranks forked from the fork server of
  ``tests/_torch_parallel_child.py``);
- (b) the DP step against the JAX ``comm_model.profile_width`` at ``d_in``
  32, dict 256, batch 64: exactly 4 bytes a parameter of gradient
  all-reduce, the total within 2% of JAX's, no all-gather, the same at
  every width; the int8 exchange's ops within 5% of JAX's (equal here);
- (c) the invariants of ``tests/test_comm_model.py`` at its shapes and
  bounds, and the SP harvest's permute bytes exactly: K and V, n − 1 hops
  a layer run, one shard's KV bytes each;
- (d) ``wire_bytes`` and ``predict`` give JAX's floats on the same
  profile at the same link rate.
"""

import dataclasses
import sys

import pytest
import torch.distributed as dist

import jax

from crosscoder_tpu.parallel import comm_model as jcm
from crosscoder_tpu_torch.models import lm
from crosscoder_tpu_torch.parallel import collectives as coll
from crosscoder_tpu_torch.parallel import comm_model as cm

from _torch_parallel_child import finish_ranks, start_ranks

SHAPE = dict(dict_size=256, d_in=32, batch_size=64)
N_PARAMS = 2 * 2 * 32 * 256 + 256 + 2 * 32         # W_enc, W_dec, b_enc, b_dec
CASES = [("train_dp", n, 1) for n in (2, 4, 8)] + [
    ("train_dp_quant", n, 1) for n in (2, 4, 8)] + [("train_dp_tp", 4, 2)]


@pytest.fixture(scope="module")
def counted(tmp_path_factory):
    """Every case on real gloo ranks (rank 0's bytes by op), and through
    ``profile_width``'s fake group in this process while the ranks run;
    the excepthook as it stood before."""
    started = start_ranks(8, {"kind": "comm", "cases": CASES, "shape": SHAPE},
                          tmp_path_factory.mktemp("comm"))
    hook = sys.excepthook
    fake = {}
    for n in (2, 4, 8):
        for p in cm.profile_width(n, programs=("train", "train_quant"), device="cpu", **SHAPE):
            fake[f"{p.program} {n}x1"] = p
    (p,) = cm.profile_width(4, model_axis=2, programs=("train_tp",), device="cpu", **SHAPE)
    fake["train_dp_tp 4x2"] = p
    return finish_ranks(started)[0], fake, hook


@pytest.fixture(scope="module")
def fake(counted):
    return counted[1]


@pytest.fixture(scope="module")
def jax_profiles():
    assert jax.device_count() >= 8
    out = {}
    for p in jcm.profile_width(2, programs=("train", "train_quant"), **SHAPE):
        out[f"{p.program} 2"] = p
    (out["train_dp 8"],) = jcm.profile_width(8, programs=("train",), **SHAPE)
    (out["train_dp_tp 4"],) = jcm.profile_width(4, model_axis=2, programs=("train_tp",), **SHAPE)
    return out


# ---------------------------------------------------------------------------
# (a) the fake group's count is the real ranks'


@pytest.mark.parametrize("case", [f"{p} {n}x{m}" for p, n, m in CASES])
def test_fake_group_counts_what_real_gloo_ranks_count(counted, case):
    real, fake, _ = counted
    got = fake[case].bytes_by_op
    assert got == real[case], (got, real[case])
    assert got["count"] > 0 and fake[case].total_bytes > 0


def test_profile_width_refuses_beside_a_joined_group_and_leaves_nothing(counted):
    real, _, hook = counted
    assert "fake process group" in real["refused"]
    assert not dist.is_initialized()
    assert sys.excepthook is hook
    assert not coll.bytes and not coll.calls


# ---------------------------------------------------------------------------
# (b) the DP step against JAX's


@pytest.mark.parametrize("n", [2, 4, 8])
def test_dp_step_all_reduces_f32_gradients_within_2pct_of_jax(fake, jax_profiles, n):
    p = fake[f"train_dp {n}x1"].bytes_by_op
    want = jax_profiles["train_dp 2"].bytes_by_op
    assert jax_profiles["train_dp 8"].bytes_by_op["all-reduce"] == want["all-reduce"] == 133_384
    # the f32 gradients of every parameter, plus a few bytes of loss terms
    assert 4 * N_PARAMS <= p["all-reduce"] <= 4 * N_PARAMS + 64, p
    assert abs(p["all-reduce"] - want["all-reduce"]) <= 0.02 * want["all-reduce"]
    assert abs(fake[f"train_dp {n}x1"].total_bytes - sum(
        v for k, v in want.items() if k != "count")) <= 0.02 * want["all-reduce"]
    assert p["all-gather"] == 0
    assert p == fake["train_dp 2x1"].bytes_by_op


def test_int8_exchange_ops_within_5pct_of_jax(fake, jax_profiles):
    got, want = fake["train_dp_quant 2x1"].bytes_by_op, jax_profiles["train_dp_quant 2"].bytes_by_op
    assert (want["all-gather"], want["all-to-all"], want["all-reduce"]) == (34_320, 34_320, 12)
    for op in ("all-reduce", "all-gather", "all-to-all", "reduce-scatter", "collective-permute"):
        assert abs(got[op] - want[op]) <= 0.05 * want[op], (op, got, want)
    # the port's exchange is JAX's byte for byte: int8 padded to n × block
    # blocks a leaf, one f32 scale a block, the loss terms' three f32
    assert {k: got[k] for k in want if k != "count"} == {k: want[k] for k in want if k != "count"}


def test_tp_step_bytes_printed_beside_jax(fake, jax_profiles):
    """The port's TP step issues collectives of its own (not GSPMD's), so
    its bytes are printed beside JAX's, not held equal."""
    got, want = fake["train_dp_tp 4x2"].bytes_by_op, jax_profiles["train_dp_tp 4"].bytes_by_op
    print(f"train_dp_tp 2 x 2: port {got}, JAX {want}")
    assert got["all-reduce"] > 0 and want["all-reduce"] > 0


# ---------------------------------------------------------------------------
# (c) JAX's invariants (tests/test_comm_model.py), at its shapes and bounds

DICT, DIN, BATCH = 2 ** 12, 128, 256


def _one(programs, n, **kw):
    profs = cm.profile_width(n, dict_size=DICT, d_in=DIN, batch_size=BATCH, programs=programs,
                             device="cpu", **kw)
    assert len(profs) == 1
    return profs[0]


def test_dp_psum_constant_in_width():
    sizes = {}
    for n in (2, 4, 8):
        p = _one(("train",), n)
        assert p.bytes_by_op["all-gather"] == 0, "weight-sized gather crept in"
        sizes[n] = p.bytes_by_op["all-reduce"]
    assert sizes[2] == sizes[4] == sizes[8], sizes
    n_params = 2 * 2 * DIN * DICT + DICT + 2 * DIN
    assert sizes[8] <= 4 * n_params * 1.05, (sizes[8], n_params)
    assert sizes[8] >= 2 * n_params


def test_tp_shards_the_psum_and_gathers_no_weight():
    dp = _one(("train",), 8)
    tp = _one(("train_tp",), 8, model_axis=2)
    assert tp.bytes_by_op["all-reduce"] < dp.bytes_by_op["all-reduce"], (tp.bytes_by_op,
                                                                        dp.bytes_by_op)
    # no all-gather the size of a weight shard (W_enc's half in bf16)
    assert tp.bytes_by_op["all-gather"] < 2 * DIN * (DICT // 2) * 2, tp.bytes_by_op


def test_sp_harvest_permute_bounded_by_kv_and_exact():
    cfg = dataclasses.replace(lm.LMConfig.tiny(), n_layers=2)
    n, b, s = 8, 8, 64
    p = _one(("sp_harvest",), n, lm_cfg=cfg, seq_len=s)
    permute = p.bytes_by_op["collective-permute"]
    assert permute > 0, "ring attention emitted no collective-permute"
    kv_total = 2 * b * s * cfg.n_kv_heads * cfg.head_dim * 4 * cfg.n_layers
    assert permute <= kv_total * 8, (permute, kv_total)
    # the blocks below the hook run: layer min(n_layers - 1, 14) is hooked
    layers = min(cfg.n_layers - 1, 14)
    shard_kv = b * (s // n) * cfg.n_kv_heads * cfg.head_dim * 4          # f32
    assert permute == 2 * (n - 1) * layers * shard_kv
    # the capture stitched on every rank: one all-gather of [b, s, d_model]
    assert p.bytes_by_op["all-gather"] == b * s * cfg.d_model * 4


def test_dp_harvest_moves_nothing():
    cfg = dataclasses.replace(lm.LMConfig.tiny(), n_layers=2)
    p = _one(("harvest",), 4, lm_cfg=cfg, seq_len=16)
    assert p.program == "harvest_dp" and p.total_bytes == 0 and p.bytes_by_op["count"] == 0


# ---------------------------------------------------------------------------
# (d) the arithmetic


@pytest.mark.parametrize("axis", [None, 1, 2, 4])
@pytest.mark.parametrize("case", ["train_dp 8x1", "train_dp_quant 4x1", "train_dp_tp 4x2"])
def test_wire_bytes_and_predict_are_jax_floats(fake, case, axis):
    p = fake[case]
    jp = jcm.CommProfile(p.program, p.n_devices, p.model_axis, dict(p.bytes_by_op))
    assert cm.wire_bytes(p, axis) == jcm.wire_bytes(jp, axis)
    assert p.total_bytes == jp.total_bytes
    for step_ms in (19.14, 0.5):
        got = cm.predict(step_ms, p, link_gbps=cm.NVLINK_GBPS)
        assert got == jcm.predict(step_ms, jp, ici_gbps=cm.NVLINK_GBPS)
    assert cm.predict(19.14, p) == jcm.predict(19.14, jp, ici_gbps=450.0)


def test_wire_factors_and_link_rate():
    assert cm._WIRE_FACTORS == jcm._WIRE_FACTORS
    assert cm.NVLINK_GBPS == 450.0          # H100 SXM5: 900 GB/s both ways, 450 each way
    one = cm.CommProfile("train_dp", 1, 1, {"all-reduce": 10, "count": 1})
    assert cm.wire_bytes(one) == 0.0
