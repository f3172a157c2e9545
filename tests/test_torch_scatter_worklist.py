"""The work list of the sorted-pair scatter (K10,
crosscoder_tpu_torch/ops/sparse_grad.py ``work_list_plain``, which the
card's list builder in csrc/scatter_rows.cu follows bitwise) on the CPU, and the
port's plain scatter against the JAX kernel it replaces
(crosscoder_tpu/ops/sparse_grad.py, interpret mode) on the AuxK term's
filler pattern.

The kernel (csrc/scatter_rows.cu) runs one block per (work item, column
slice); every slice of an item walks the same rows and pairs, so covering
each (destination, column slice) once is covering each destination once.
``_walk`` repeats the kernel's walk over an item in Python: the item's
pairs in order, each of its rows written once, ``acc = acc + c · r`` in
f32 from 0. Bars: the walk over the whole list is bitwise the plain
version on any input; the plain version is bitwise JAX's on
integer-valued inputs, whose f32 sums are exact in any order, and on
random ones within 1e-6 of each element's sum of |c·r| (+ 1e-6): the
interpreter may contract each multiply-add into an FMA, and a filler
column sums every row of the batch, so the flat 1e-6 of
tests/test_torch_topk_ops.py (a few pairs a destination) is scaled by the
magnitude of the terms."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from crosscoder_tpu.ops import sparse_grad as jsg
from crosscoder_tpu_torch.models.crosscoder import _exact_topk_indices
from crosscoder_tpu_torch.ops import sparse_grad

T, RB = sparse_grad._T, sparse_grad._RB


def _auxk_idx(seed, B, H, k_aux, n_dead):
    """The AuxK term's indices and dead mask (models/crosscoder.get_losses):
    live latents ranked at finfo.min, the top k_aux of each row by the
    exact ranking, so with fewer than k_aux dead latents every row also
    takes the lowest live columns."""
    rng = np.random.default_rng(seed)
    h = torch.from_numpy(rng.standard_normal((B, H)).astype(np.float32))
    dead = torch.zeros(H, dtype=torch.bool)
    dead[torch.from_numpy(rng.permutation(H)[:n_dead])] = True
    ranked = torch.where(dead[None, :], h, torch.finfo(torch.float32).min)
    return _exact_topk_indices(ranked, k_aux).to(torch.int32), dead


def _pattern(name, seed=0):
    """``(idx [B, k] int32, n_out)`` of one destination pattern."""
    rng = np.random.default_rng(seed)
    if name == "random":
        return torch.from_numpy(rng.integers(0, 1000, (64, 8)).astype(np.int32)), 1000
    if name.startswith("auxk"):                         # auxk<dead>
        return _auxk_idx(seed, 96, 200, 16, int(name[4:]))[0], 200
    if name == "one destination":
        return torch.full((130, 4), 17, dtype=torch.int32), 100
    if name == "T and T+1":
        idx = torch.from_numpy(rng.integers(0, 90, (T + 1, 3)).astype(np.int32))
        idx[:, 0] = 40                                  # T + 1 pairs
        idx[:T, 1] = 41                                 # T pairs
        idx[T, 1] = 5
        return idx, 90
    if name == "hot and cold in one group":
        idx = torch.from_numpy(rng.integers(64, 96, (300, 4)).astype(np.int32))
        idx[:, 0] = 70                                  # hot, among cold rows 64..95
        return idx, 101                                 # n_out not a multiple of RB
    if name == "dropped":
        idx = torch.from_numpy(rng.integers(-3, 53, (40, 8)).astype(np.int32))
        idx[0, 0], idx[1, 0] = -1, 50                   # -1 and n_out
        return idx, 50
    if name == "many hot rows at T+1":
        idx = torch.arange(4 * (T + 1), dtype=torch.int32).reshape(T + 1, 4) % 4 * 7
        return idx, 33
    raise KeyError(name)


PATTERNS = ["random", "auxk0", "auxk5", "auxk15", "auxk40", "one destination", "T and T+1",
            "hot and cold in one group", "dropped", "many hot rows at T+1"]


def _sorted(idx, n_out, seed=1, m=8, integer=True):
    rng = np.random.default_rng(seed)
    if integer:
        coeff = rng.integers(-4, 5, idx.shape).astype(np.float32)
        rows = rng.integers(-8, 9, (idx.shape[0], m)).astype(np.float32)
    else:
        coeff = rng.standard_normal(idx.shape).astype(np.float32)
        rows = rng.standard_normal((idx.shape[0], m)).astype(np.float32)
    coeff[0, 0] = 0.0                                   # zero coefficients stay
    coeff, rows = torch.from_numpy(coeff), torch.from_numpy(rows)
    dst, src, cf = sparse_grad.sorted_pairs(coeff, idx, n_out)
    return coeff, rows, dst, src, cf


def _walk(items, dst, src, cf, rows, n_out):
    """K10's walk over every item: ``(out, writes per row)``."""
    out = torch.full((n_out, rows.shape[1]), float("nan"))
    writes = torch.zeros(n_out, dtype=torch.int64)
    for r0, r1, s, e in items.tolist():
        cur, acc = r0, torch.zeros(rows.shape[1])
        for p in range(s, e + 1):                       # each pair, then the item's end
            d = int(dst[p]) if p < e else r1
            assert r0 <= d < r1 or p == e
            while cur < d:                              # rows the walk has passed
                out[cur], writes[cur] = acc, writes[cur] + 1
                acc, cur = torch.zeros_like(acc), cur + 1
            if p < e:
                acc = acc + cf[p] * rows[src[p]]
    return out, writes


@pytest.mark.parametrize("name", PATTERNS)
def test_every_destination_is_covered_exactly_once(name):
    idx, n_out = _pattern(name)
    _, rows, dst, src, cf = _sorted(idx, n_out)
    items = sparse_grad.work_list_plain(dst, n_out)
    _, writes = _walk(items, dst, src, cf, rows, n_out)
    assert torch.equal(writes, torch.ones(n_out, dtype=torch.int64))
    # and every in-range pair exactly once, in one item's range
    hits = torch.zeros(dst.numel(), dtype=torch.int64)
    for _, _, s, e in items.tolist():
        hits[s:e] += 1
    assert torch.equal(hits, (dst < n_out).long())


@pytest.mark.parametrize("name", PATTERNS)
def test_hot_destinations_are_items_of_their_own_in_sorted_order(name):
    idx, n_out = _pattern(name)
    _, _, dst, src, _ = _sorted(idx, n_out)
    items = sparse_grad.work_list_plain(dst, n_out)
    counts = torch.bincount(dst[dst < n_out], minlength=n_out)
    for r in torch.nonzero(counts > T).flatten().tolist():
        mine = [it for it in items.tolist() if it[0] <= r < it[1]]
        assert len(mine) == 1 and mine[0][:2] == [r, r + 1]
        s, e = mine[0][2:]
        assert e - s == int(counts[r]) and bool((dst[s:e] == r).all())
        # the batch-major order of the pairs: source rows ascending, each
        # (row, slot) pair once, as the stable sort leaves them
        flat = torch.nonzero(idx.reshape(-1) == r).flatten()
        assert torch.equal(src[s:e], torch.div(flat, idx.shape[1], rounding_mode="floor"))
    for r0, r1, s, e in items.tolist():
        if r1 - r0 > 1 or (r1 > r0 and int(counts[r0]) <= T):
            assert r1 - r0 <= RB and e - s < 2 * T          # a cold item


@pytest.mark.parametrize("name", PATTERNS)
def test_work_list_never_exceeds_its_bound(name):
    idx, n_out = _pattern(name)
    _, _, dst, _, _ = _sorted(idx, n_out)
    items = sparse_grad.work_list_plain(dst, n_out)
    bound = sparse_grad.work_list_bound(n_out, idx.numel())
    assert items.shape == (bound, 4) and items.dtype == torch.int32
    assert int((items[:, 0] < items[:, 1]).sum()) <= bound


@pytest.mark.parametrize("n_out,per_row", [(64, T + 1), (300, T), (40, 2 * T + 3), (7, 1)])
def test_bound_holds_when_every_row_is_hot_or_at_the_threshold(n_out, per_row):
    idx = torch.arange(n_out, dtype=torch.int32).repeat(per_row).reshape(per_row, n_out)
    _, _, dst, _, _ = _sorted(idx, n_out)
    items = sparse_grad.work_list_plain(dst, n_out)
    live = items[items[:, 0] < items[:, 1]]
    assert len(live) <= sparse_grad.work_list_bound(n_out, idx.numel())
    assert int((live[:, 1] - live[:, 0]).sum()) == n_out


@pytest.mark.parametrize("name", PATTERNS)
def test_empty_items_are_harmless_and_the_walk_is_the_plain_version(name):
    idx, n_out = _pattern(name)
    for integer in (True, False):
        coeff, rows, dst, src, cf = _sorted(idx, n_out, integer=integer)
        items = sparse_grad.work_list_plain(dst, n_out)
        tail = items[items[:, 0] >= items[:, 1]]
        assert bool(((tail[:, 0] == n_out) & (tail[:, 1] == n_out)
                     & (tail[:, 2] == tail[:, 3])).all())
        # hot items first, then cold ones, each in row order, then the tail
        counts = torch.bincount(dst[dst < n_out], minlength=n_out)
        live = items[items[:, 0] < items[:, 1]]
        hot = counts[live[:, 0].long()] > T
        assert not bool((~hot[:-1] & hot[1:]).any())
        for part in (live[hot], live[~hot]):
            assert bool((part[1:, 0] > part[:-1, 0]).all())
        assert torch.equal(items[len(live):], tail)
        out, _ = _walk(items, dst, src, cf, rows, n_out)
        want = sparse_grad.scatter_add_rows_plain(coeff, idx, rows, n_out)
        assert torch.equal(out.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("n_dead", [0, 3, 8, 20])
@pytest.mark.parametrize("integer", [True, False])
def test_plain_scatter_matches_jax_kernel_on_auxk_filler(n_dead, integer):
    idx, dead = _auxk_idx(n_dead, 32, 256, 8, n_dead)
    rng = np.random.default_rng(n_dead + 1)
    if integer:
        coeff = rng.integers(-4, 5, idx.shape).astype(np.float32)
        rows = rng.integers(-8, 9, (32, 128)).astype(np.float32)
    else:
        coeff = rng.standard_normal(idx.shape).astype(np.float32)
        rows = rng.standard_normal((32, 128)).astype(np.float32)
    coeff = np.where(dead.numpy()[idx.numpy()], coeff, 0.0).astype(np.float32)   # fillers: 0
    idx = idx.numpy()
    want = jsg.scatter_add_rows(jnp.asarray(coeff), jnp.asarray(idx), jnp.asarray(rows), 256,
                                use_pallas=True)
    got = sparse_grad.scatter_add_rows(torch.from_numpy(coeff), torch.from_numpy(idx),
                                       torch.from_numpy(rows), 256)
    if integer:
        np.testing.assert_array_equal(got.numpy().view(np.int32), np.asarray(want).view(np.int32))
    else:
        # a filler column sums all 32 rows: the bar is 1e-6 of the sum of |c·r|
        scale = sparse_grad.scatter_add_rows(torch.from_numpy(np.abs(coeff)), torch.from_numpy(idx),
                                             torch.from_numpy(np.abs(rows)), 256).numpy()
        assert np.all(np.abs(got.numpy() - np.asarray(want)) <= 1e-6 * scale + 1e-6)


def test_work_list_on_cpu_tensors_is_the_plain_version():
    idx, n_out = _pattern("hot and cold in one group")
    _, _, dst, _, _ = _sorted(idx, n_out)
    assert torch.equal(sparse_grad.work_list(dst, n_out), sparse_grad.work_list_plain(dst, n_out))
