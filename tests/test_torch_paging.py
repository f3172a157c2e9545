"""The port's numpy copy of the paging runtime (crosscoder_tpu_torch/data/paging.py)
produces the same arrays as the JAX package's, case by case."""

import numpy as np
import pytest

from crosscoder_tpu.data import paging as jpaging
from crosscoder_tpu_torch.data import paging


def _chunk_arrays(c):
    return [c.tokens, c.pos, c.doc_row, c.doc_off, c.lengths, c.doc_idx, c.plane_idx]


def _pack(mod, lengths, S, **kw):
    tokens = np.random.default_rng(len(lengths)).integers(1, 99, size=(len(lengths), S))
    return _chunk_arrays(mod.pack_chunk(tokens, np.asarray(lengths), **kw))


def _pages(mod):
    pt = mod.PageTable(12, 4)
    out = [pt.alloc(0, 9), pt.alloc(1, 1), pt.extend(0, 15), pt.alloc(2, 40)]
    pt.free(1)
    out += [pt.alloc(3, 5), pt.n_free, pt.table([0, 3]), pt.pages_of(0), pt.pages_needed(13)]
    return out


def _batcher(mod):
    pt = mod.PageTable(8, 4)
    cb = mod.ContinuousBatcher(seq_len=8, n_rows=2, page_table=pt, max_wait_s=0.5)
    admitted = [cb.admit(np.full(n, n, np.int32), now=float(n)) for n in (5, 3, 4, 2, 8)]
    due = [cb.due(t) for t in (5.2, 5.6)]
    chunk = cb.flush()
    return [admitted, due, pt.n_free, *_chunk_arrays(chunk), cb.flush()]


def _plane_rows(mod):
    return [mod.plane_rows(r, d, m) for r, d, m in
            [(1, 8, 1), (3, 8, 1), (5, 64, 4), (64, 64, 1), (9, 16, 8)]]


CASES = {
    "pack_mixed": lambda m: _pack(m, [1, 16, 7, 3, 9, 5, 16, 2], 16),
    "pack_full_identity": lambda m: _pack(m, [16, 16, 16], 16),
    "pack_pinned_rows": lambda m: _pack(m, [5, 3, 1], 16, n_rows=4),
    "pack_row_multiple": lambda m: _pack(m, [2] * 10, 16, row_multiple=4),
    "page_table": _pages,
    "batcher": _batcher,
    "plane_rows": _plane_rows,
    "pack_documents": lambda m: list(m.pack_documents(np.array([6, 6, 2, 8, 1]), 8)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_jax_paging(case):
    mine, theirs = CASES[case](paging), CASES[case](jpaging)
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        if isinstance(b, np.ndarray):
            assert isinstance(a, np.ndarray) and a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b
