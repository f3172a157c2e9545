"""Pretokenized corpus loading, ported from :mod:`crosscoder_tpu.data.tokens`.

The corpus is ``ckkissane/pile-lmsys-mix-1m-tokenized-gemma-2`` (50% Pile,
50% LmSys chat, pretokenized for Gemma-2 at 1024 tokens a row). The port
reads only local caches, in this order:

- ``<data_dir>/<name>.npy``: int token matrix, memory-mapped;
- ``<data_dir>/<name>.pt``: a saved torch tensor (the reference's cache).

With neither present :func:`load_pile_lmsys_mixed_tokens` raises
:class:`FileNotFoundError` naming the expected ``.npy`` path: the port
downloads nothing.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

from crosscoder_tpu_torch.config import CrossCoderConfig

# Gemma's <pad> token; trailing pad tokens mark a row's ragged length.
PAD_ID = 0


def valid_lengths(tokens: np.ndarray, pad_id: int = PAD_ID) -> np.ndarray:
    """Per-row document length: tokens up to (and including) the last
    non-pad position; a row of pure padding counts as length 1."""
    tokens = np.asarray(tokens)
    nz = tokens != pad_id
    lengths = tokens.shape[1] - np.argmax(nz[:, ::-1], axis=1)
    return np.where(nz.any(axis=1), lengths, 1).astype(np.int32)


def length_stats(tokens_or_lengths: np.ndarray, seq_len: int | None = None,
                 n_buckets: int = 8, pad_id: int = PAD_ID, sample_rows: int = 4096) -> dict:
    """Document-length distribution of a corpus, sampled on ``sample_rows``
    rows strided evenly across it: histogram buckets, mean/median length
    and the padding efficiency (real tokens over padded tokens). Takes a
    2-D token matrix or a 1-D length array (then ``seq_len`` is needed)."""
    arr = np.asarray(tokens_or_lengths)
    stride = max(1, -(-arr.shape[0] // sample_rows))
    if arr.ndim == 2:
        seq_len = arr.shape[1]
        lengths = valid_lengths(np.asarray(arr[::stride][:sample_rows]), pad_id)
    else:
        if seq_len is None:
            raise ValueError("seq_len is required with precomputed lengths")
        lengths = arr[::stride][:sample_rows].astype(np.int64)
    if lengths.size == 0:
        raise ValueError("empty corpus")
    edges = np.linspace(0, seq_len, n_buckets + 1)
    hist, _ = np.histogram(lengths, bins=edges)
    eff = float(lengths.sum() / (lengths.size * seq_len))
    return {
        "n_sampled": int(lengths.size),
        "seq_len": int(seq_len),
        "mean_len": round(float(lengths.mean()), 1),
        "median_len": int(np.median(lengths)),
        "min_len": int(lengths.min()),
        "max_len": int(lengths.max()),
        "bucket_edges": [int(e) for e in edges],
        "bucket_counts": [int(c) for c in hist],
        "padding_efficiency": round(eff, 4),
        "paged_matmul_speedup_estimate": round(1.0 / max(eff, 1e-9), 2),
    }


def rechunk(tokens: np.ndarray, seq_len: int) -> np.ndarray:
    """Reshape a pretokenized ``[n, w]`` corpus to width ``seq_len`` by
    joining whole rows (``seq_len`` a multiple of ``w``); views only.
    Shorter widths are refused: their pieces would start without BOS."""
    w = tokens.shape[1]
    if seq_len == w:
        return tokens
    if seq_len % w == 0:
        f = seq_len // w
        n = tokens.shape[0] // f * f
        if n == 0:
            raise ValueError(f"corpus has {tokens.shape[0]} rows of {w}; "
                             f"cannot form one {seq_len}-token sequence")
        return tokens[:n].reshape(-1, seq_len)
    raise ValueError(
        f"seq_len {seq_len} must be a multiple of the corpus width {w} "
        f"(shorter lengths would produce BOS-less sequences; re-tokenize "
        f"at {seq_len} instead)"
    )


def _emit_length_stats(tokens: np.ndarray) -> np.ndarray:
    s = length_stats(tokens)
    print(f"[crosscoder_tpu_torch] corpus lengths (n={s['n_sampled']} sampled): "
          f"mean {s['mean_len']}/{s['seq_len']}, padding efficiency "
          f"{s['padding_efficiency']:.2%}", file=sys.stderr)
    return tokens


def load_pile_lmsys_mixed_tokens(cfg: CrossCoderConfig, mmap: bool = True) -> np.ndarray:
    """Token matrix ``[n_seqs, cfg.seq_len]`` from the local cache under
    ``cfg.data_dir`` (re-chunked from the corpus's width when they differ)."""
    name = cfg.dataset_name.split("/")[-1]
    data_dir = Path(cfg.data_dir)
    npy = data_dir / f"{name}.npy"
    if npy.exists():
        return _emit_length_stats(rechunk(np.load(npy, mmap_mode="r" if mmap else None),
                                          cfg.seq_len))
    pt = data_dir / f"{name}.pt"
    if pt.exists():
        import torch

        tokens = torch.load(pt, map_location="cpu").numpy()
        return _emit_length_stats(rechunk(
            np.ascontiguousarray(tokens.astype(np.int32, copy=False)), cfg.seq_len))
    raise FileNotFoundError(
        f"no token cache for {cfg.dataset_name}: expected {npy} (an int token matrix "
        f"[n_seqs, width]) or {pt}; the port reads local caches only and downloads "
        f"nothing")
