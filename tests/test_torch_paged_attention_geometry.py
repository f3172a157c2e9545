"""The port's ragged paged attention at the head geometry of Gemma-2-27B's
attention (head_dim 128, two query heads a KV head) against the JAX
package's: the port's plain version (the wrapper on CPU tensors) vs the
Pallas kernel run in interpret mode and vs the JAX reference, on the same
numpy inputs made from a seed, in fp32 (1e-5 on valid rows) and in bf16
(2e-2 on valid rows, and 2e-2 of each row's largest output), at the query
scale 1/16 of Gemma-2-2B and 9B and 144^-0.5 = 1/12 of 27B. The bf16
rounding of ``q * scale`` that the Hopper kernel must repeat is pinned
where it shows (1/12) and where it is exact (1/16); and ``check_supported``
refuses what it refused before the kernel took TMA. The Hopper kernel is
held against the plain version in test_torch_kernels_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from crosscoder_tpu.ops import paged_attention as jpa
from crosscoder_tpu_torch.ops import paged_attention as pa

D, S, H, KV, HD, PAGE = 3, 32, 4, 2, 128, 8          # g = 2
LENGTHS = np.array([1, 32, 13], np.int32)             # a single token, full, mid-page
SCALES = {"2b": 256 ** -0.5, "27b": 144 ** -0.5}
BARS = {"fp32": 1e-5, "bf16": 2e-2}


@pytest.fixture(autouse=True)
def _jax_kernels_plain():
    """Interpret mode is passed per call; keep the module switch off for
    whatever else shares this worker."""
    jpa.set_interpret(False)
    yield
    jpa.set_interpret(False)


@pytest.fixture(scope="module")
def qkv():
    rng = np.random.default_rng(26)
    return (rng.normal(size=(D, S, H, HD)).astype(np.float32),
            rng.normal(size=(D, S, KV, HD)).astype(np.float32),
            rng.normal(size=(D, S, KV, HD)).astype(np.float32))


def _torch(a, dtype):
    return torch.from_numpy(a).to(torch.bfloat16 if dtype == "bf16" else torch.float32)


def _jax(a, dtype):
    return jnp.asarray(a, dtype=jnp.bfloat16 if dtype == "bf16" else jnp.float32)


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _assert_close(got, want, dtype, what):
    """Valid rows within the dtype's bar, and in bf16 each row (a position
    and head) within the bar of its largest output."""
    tol = BARS[dtype]
    for d, ln in enumerate(LENGTHS):
        x = got[d, :ln].reshape(ln, H, HD)
        y = want[d, :ln].reshape(ln, H, HD)
        err = np.abs(x - y)
        assert err.max() <= tol, f"{what} doc {d}: {err.max()} > {tol}"
        if dtype == "bf16":
            rel = err.max(-1) / np.maximum(np.abs(y).max(-1), 1e-30)
            assert rel.max() <= tol, f"{what} doc {d}: row-relative {rel.max()} > {tol}"


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("scale", sorted(SCALES))
@pytest.mark.parametrize("window,softcap", [(0, 50.0), (5, 50.0), (0, 0.0), (12, 0.0)])
def test_plain_matches_jax_at_head_dim_128(qkv, dtype, scale, window, softcap):
    tq, tk, tv = (_torch(a, dtype) for a in qkv)
    jq, jk, jv = (_jax(a, dtype) for a in qkv)
    kw = dict(scale=SCALES[scale], softcap=softcap, window=window)
    got = pa.paged_attention(tq, tk, tv, torch.from_numpy(LENGTHS), page_size=PAGE, **kw)
    assert got.shape == (D, S, H * HD) and got.dtype == tq.dtype
    got = got.float().numpy()
    kernel = _f32(jpa.paged_attention(jq, jk, jv, jnp.asarray(LENGTHS), page_size=PAGE,
                                      interpret=True, **kw))
    ref = _f32(jpa.ragged_attention_reference(jq, jk, jv, jnp.asarray(LENGTHS),
                                              is_local=bool(window), **kw))
    _assert_close(got, kernel, dtype, "vs the Pallas kernel (interpret)")
    _assert_close(got, ref, dtype, "vs the JAX reference")


@pytest.mark.parametrize("scale,rounds", [("2b", False), ("27b", True)])
def test_bf16_q_scale_rounding(qkv, scale, rounds):
    """In bf16 the plain version (and so the kernel's bar) takes
    ``q * scale`` rounded to bf16 from its f32 product, as the kernel
    rounds it in shared memory: bitwise the plain version on that rounded
    q at scale 1. At 1/16 the product is exact; at 1/12 the rounding moves
    some of it, and so the output."""
    s = SCALES[scale]
    q, k, v = (_torch(a, "bf16") for a in qkv)
    lens = torch.from_numpy(LENGTHS)
    q_scaled = (q.float() * s).to(torch.bfloat16)
    assert bool((q_scaled.float() != q.float() * s).any()) == rounds
    kw = dict(page_size=PAGE, softcap=50.0)
    got = pa.paged_attention(q, k, v, lens, scale=s, **kw)
    assert torch.equal(got.view(torch.int16),
                       pa.paged_attention(q_scaled, k, v, lens, scale=1.0, **kw).view(torch.int16))
    unrounded = pa.paged_attention(q.float() * s, k.float(), v.float(), lens, scale=1.0, **kw)
    moved = float((unrounded - pa.paged_attention(q_scaled.float(), k.float(), v.float(), lens,
                                                  scale=1.0, **kw)).abs().max())
    assert (moved > 0) == rounds


def _shape(D_=2, S_=64, H_=4, KV_=2, hd=128):
    return torch.zeros(D_, S_, H_, hd), torch.zeros(D_, S_, KV_, hd)


@pytest.mark.parametrize("case,match", [
    ("hd 64", "head_dim"), ("hd 96", "head_dim"), ("page 16", "page_size"),
    ("page 128", "page_size"), ("S % page", "not divisible"), ("fp16", "float32 or bfloat16"),
    ("k/v dtype", "float32 or bfloat16"), ("g 3", "query group"), ("g 64", "query group"),
    ("KV does not divide H", "query group"), ("lengths", "lengths must be"),
    ("k shape", "do not match"), ("v shape", "expected q"), ("3-d q", "expected q"),
])
def test_check_supported_refusals(case, match):
    """Every refusal of ``check_supported``, by its message: the TMA
    kernel narrows nothing."""
    q, kv = _shape()
    k = v = kv
    lens, page = torch.ones(2), 32
    if case == "hd 64":
        q, kv = _shape(hd=64)
        k = v = kv
    elif case == "hd 96":
        q, kv = _shape(hd=96)
        k = v = kv
    elif case == "page 16":
        page = 16
    elif case == "page 128":
        q, kv = _shape(S_=128)
        k = v = kv
        page = 128
    elif case == "S % page":
        q, kv = _shape(S_=96)
        k = v = kv
        page = 64
    elif case == "fp16":
        q, k, v = q.half(), k.half(), v.half()
    elif case == "k/v dtype":
        k = v = kv.bfloat16()
    elif case == "g 3":
        q, kv = _shape(H_=6, KV_=2)
        k = v = kv
    elif case == "g 64":
        q, kv = _shape(H_=64, KV_=1)
        k = v = kv
    elif case == "KV does not divide H":
        q, kv = _shape(H_=6, KV_=4)
        k = v = kv
    elif case == "lengths":
        lens = torch.ones(3)
    elif case == "k shape":
        k = v = torch.zeros(2, 32, 2, 128)
    elif case == "v shape":
        v = torch.zeros(2, 64, 1, 128)
    elif case == "3-d q":
        q = q[0]
    with pytest.raises(ValueError, match=match):
        pa.check_supported(q, k, v, lens, page)


@pytest.mark.parametrize("hd", [128, 256])
@pytest.mark.parametrize("page", [32, 64])
@pytest.mark.parametrize("g", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_check_supported_takes(hd, page, g, dtype):
    """What it took before it still takes: head_dim 128 and 256, page 32
    and 64, every query group dividing 32, bf16 and f32."""
    q = torch.zeros(1, 2 * page, g, hd, dtype=dtype)
    kv = torch.zeros(1, 2 * page, 1, hd, dtype=dtype)
    pa.check_supported(q, kv, kv, torch.ones(1), page)
