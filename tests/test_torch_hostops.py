"""The port's replay-store row ops (crosscoder_tpu_torch/data/hostops.py)
against the JAX package's native row ops (crosscoder_tpu/native), on the
same seeded bf16 stores. Bar: byte-identical results and stores, the same
index rules (negatives wrap, out of range raises)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from crosscoder_tpu import native
from crosscoder_tpu_torch.data import hostops


def _store(n=64, n_sources=2, d=24, seed=0):
    x = np.random.default_rng(seed).normal(size=(n, n_sources, d)).astype(np.float32) * 5
    j = x.astype(jnp.bfloat16)
    t = torch.from_numpy(j.view(np.int16).copy()).view(torch.bfloat16)
    return j, t


def _bits(t):
    return t.contiguous().view(torch.int16).numpy()


IDX = {"perm": np.random.default_rng(1).permutation(64)[:32],
       "repeats": np.array([3, 3, 0, 63, 3]),
       "negative": np.array([-1, -64, 5, -7]),
       "empty": np.zeros((0,), np.int64)}


@pytest.mark.parametrize("case", sorted(IDX))
def test_gather_rows_bytes_equal_native(case):
    j, t = _store()
    want = native.gather_rows(j, IDX[case])
    np.testing.assert_array_equal(_bits(hostops.gather_rows(t, IDX[case])), want.view(np.int16))


@pytest.mark.parametrize("case", sorted(IDX))
def test_gather_scale_f32_bytes_equal_native(case):
    j, t = _store()
    scale = np.array([0.37, 1.9], np.float32)
    want = native.gather_scale_f32(j, IDX[case], scale)
    got = hostops.gather_scale_f32(t, IDX[case], scale)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("case", ["perm", "negative"])
def test_scatter_rows_bytes_equal_native(case):
    j, t = _store()
    rj, rt = _store(n=len(IDX[case]), seed=2)
    native.scatter_rows(j, IDX[case], rj)
    hostops.scatter_rows(t, IDX[case], rt)
    np.testing.assert_array_equal(_bits(t), j.view(np.int16))


def test_scatter_rows_other_dtypes_and_validation():
    """The int8 store's payload and f32 scales go through the same ops."""
    q = torch.zeros((8, 2, 4), dtype=torch.int8)
    hostops.scatter_rows(q, np.array([6, 1]), torch.tensor([[[1] * 4] * 2, [[-2] * 4] * 2],
                                                           dtype=torch.int8))
    assert q[6].eq(1).all() and q[1].eq(-2).all() and q.abs().sum() == 24
    _, t = _store()
    with pytest.raises(IndexError, match="out of range"):
        hostops.gather_rows(t, np.array([64]))
    with pytest.raises(IndexError, match="pos out of range"):
        hostops.scatter_rows(t, np.array([-65]), t[:1])
    with pytest.raises(ValueError, match="does not match store"):
        hostops.scatter_rows(t, np.array([0]), t[:1].float())
    with pytest.raises(ValueError, match="scale must be"):
        hostops.gather_scale_f32(t, np.array([0]), np.ones(3, np.float32))
    with pytest.raises(ValueError, match="store must be"):
        hostops.gather_scale_f32(t[:, 0], np.array([0]), np.ones(2, np.float32))
