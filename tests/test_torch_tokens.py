"""The port's token helpers (crosscoder_tpu_torch/data/tokens.py) against the
JAX package's data/tokens.py: equal outputs on the same numpy corpora; the
loader reads a local ``.npy`` cache and raises FileNotFoundError naming
the expected path without one (the port downloads nothing)."""

import numpy as np
import pytest

from crosscoder_tpu.config import CrossCoderConfig as JCfg
from crosscoder_tpu.data import tokens as jtokens
from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.data import tokens


def _corpus(n=300, w=64, seed=0):
    rng = np.random.default_rng(seed)
    t = rng.integers(1, 1000, size=(n, w), dtype=np.int32)
    lengths = rng.integers(1, w + 1, size=n)
    for i, ln in enumerate(lengths):
        t[i, ln:] = tokens.PAD_ID
    t[3] = tokens.PAD_ID                                 # pure padding
    t[4, w // 2] = tokens.PAD_ID                         # an inner pad is content
    return t


def test_valid_lengths_equal_jax():
    t = _corpus()
    assert tokens.PAD_ID == jtokens.PAD_ID
    np.testing.assert_array_equal(tokens.valid_lengths(t), jtokens.valid_lengths(t))
    assert tokens.valid_lengths(t)[3] == 1


@pytest.mark.parametrize("kw", [dict(), dict(n_buckets=3, sample_rows=50)])
def test_length_stats_equal_jax(kw):
    t = _corpus(n=5000)
    assert tokens.length_stats(t, **kw) == jtokens.length_stats(t, **kw)
    ln = tokens.valid_lengths(t)
    assert tokens.length_stats(ln, seq_len=64, **kw) == jtokens.length_stats(ln, seq_len=64, **kw)
    with pytest.raises(ValueError, match="seq_len"):
        tokens.length_stats(ln)


def test_rechunk_equals_jax():
    t = _corpus(n=9, w=8)
    for s in (8, 16, 24):
        np.testing.assert_array_equal(tokens.rechunk(t, s), jtokens.rechunk(t, s))
    for s in (4, 12):
        with pytest.raises(ValueError, match="multiple"):
            tokens.rechunk(t, s)
    with pytest.raises(ValueError, match="cannot form"):
        tokens.rechunk(t[:1], 16)


def test_loader_reads_local_npy_and_pt_and_refuses_to_download(tmp_path):
    import torch

    cfg = CrossCoderConfig(data_dir=str(tmp_path), seq_len=128)
    name = cfg.dataset_name.split("/")[-1]
    with pytest.raises(FileNotFoundError, match=f"{name}.npy"):
        tokens.load_pile_lmsys_mixed_tokens(cfg)
    t = _corpus(n=10, w=64)
    torch.save(torch.from_numpy(t.astype(np.int64)), tmp_path / f"{name}.pt")
    got_pt = tokens.load_pile_lmsys_mixed_tokens(cfg)
    np.save(tmp_path / f"{name}.npy", t)
    got = tokens.load_pile_lmsys_mixed_tokens(cfg)
    want = jtokens.load_pile_lmsys_mixed_tokens(JCfg(data_dir=str(tmp_path), seq_len=128))
    assert got.shape == (5, 128)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_pt, want)
