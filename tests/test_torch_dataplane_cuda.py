"""The compiled data plane on the card: the fused optimizer update (O1,
``csrc/adam_update.cu``) against its plain version, K1 at the paged
harvest's shapes, and the refill dispatcher launching on the buffer's
stream. Every test needs a CUDA device and skips without one; the file
imports no JAX:

    python -m pytest -m cuda tests/test_torch_dataplane_cuda.py

Bars: O1 bitwise (it rounds every step as the plain version's eager ops
do), below and above the clip, f32 and bf16 masters, in place and into
fresh outputs, leaves whose lengths are not a multiple of a block or of a
16-byte vector, and unaligned leaves; K1 at 2e-2 in bf16 on valid rows
and to 2e-2 of each row's largest output (online softmax; tests/
test_torch_kernels_cuda.py's bar); a paged harvest against its plain-
attention re-run at a relative error of 2e-2 per source (bf16 forwards
through a few layers, each attention output within K1's bar); the
overlap buffer's served stream bitwise to overlap off."""

import numpy as np
import pytest
import torch

from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.data import buffer as buf
from crosscoder_tpu_torch.data.tokens import valid_lengths
from crosscoder_tpu_torch.models import lm
from crosscoder_tpu_torch.ops import adam
from crosscoder_tpu_torch.ops import paged_attention as pa
from crosscoder_tpu_torch.train.state import Optimizer

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _leaves(shapes, dtype, gen, scale=1.0, positive=False):
    out = {}
    for k, s in shapes.items():
        t = torch.randn(s, generator=gen, device="cuda") * scale
        out[k] = (t.abs() if positive else t).to(dtype)
    return out


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


SHAPES = [
    {"W_enc": (2, 64, 1000), "W_dec": (1000, 2, 64), "b_enc": (1000,), "b_dec": (2, 64)},
    {"a": (1_000_003,), "b": (7,), "c": (1,), "d": (2048 * 3 + 5,)},
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("norm", [0.5, 4.0])
@pytest.mark.parametrize("shapes", SHAPES, ids=["crosscoder", "ragged"])
@pytest.mark.parametrize("in_place", [True, False])
def test_adam_update_kernel_bitwise_matches_plain(cuda, dtype, norm, shapes, in_place):
    gen = torch.Generator(device="cuda").manual_seed(7)
    params = _leaves(shapes, dtype, gen, 0.1)
    grads = _leaves(shapes, dtype, gen)
    mu = _leaves(shapes, dtype, gen, 0.01)
    nu = _leaves(shapes, dtype, gen, 0.01, positive=True)
    g_norm = Optimizer.global_norm(grads)
    grads = {k: (g * (norm / g_norm)).to(dtype) for k, g in grads.items()}
    g_norm = Optimizer.global_norm(grads)
    assert bool(g_norm < 1.0) == (norm < 1.0)
    kw = dict(max_norm=1.0, b1=0.9, b2=0.999, eps=1e-8, bc1=float(np.float32(0.271)),
              bc2=float(np.float32(0.002997)), step_size=float(-np.float32(1e-3)))
    want = tuple({k: v.clone() for k, v in d.items()} for d in (params, mu, nu))
    adam.adam_update_plain(want[0], grads, want[1], want[2], g_norm, **kw)
    before = adam.adam_update.launches
    if in_place:
        got = tuple({k: v.clone() for k, v in d.items()} for d in (params, mu, nu))
        adam.adam_update(got[0], grads, got[1], got[2], g_norm, **kw)
    else:
        got = tuple({k: torch.empty_like(v) for k, v in d.items()} for d in (params, mu, nu))
        adam.adam_update(params, grads, mu, nu, g_norm, out=got, **kw)
    torch.cuda.synchronize()
    assert adam.adam_update.launches == before + 1
    for g, w in zip(got, want):
        for k in g:
            assert torch.equal(_bits(g[k]), _bits(w[k])), k


def test_adam_update_kernel_takes_unaligned_leaves(cuda):
    """Views one element into their storage take the element-by-element
    path and still match the plain version bitwise."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    base = {k: torch.randn(4097, generator=gen, device="cuda") for k in "pgmv"}
    base["v"] = base["v"].abs()
    leaf = {k: t[1:] for k, t in base.items()}
    assert leaf["p"].data_ptr() % 16
    norm = torch.tensor(0.3, device="cuda")
    kw = dict(max_norm=1.0, b1=0.9, b2=0.999, eps=1e-8, bc1=0.1, bc2=0.001, step_size=-1e-3)
    want = [{"x": leaf[k].clone()} for k in "pmv"]
    adam.adam_update_plain(want[0], {"x": leaf["g"]}, want[1], want[2], norm, **kw)
    got = [{"x": leaf[k]} for k in "pmv"]
    adam.adam_update(got[0], {"x": leaf["g"]}, got[1], got[2], norm, **kw)
    for g, w in zip(got, want):
        assert torch.equal(_bits(g["x"]), _bits(w["x"]))


def test_adam_update_kernel_takes_strided_gradients(cuda):
    """A gradient that is a transposed or expanded view (as autograd can
    return) is read through a contiguous copy: bitwise the plain version."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    p, m = (torch.randn((64, 48), generator=gen, device="cuda") for _ in range(2))
    v = torch.randn((64, 48), generator=gen, device="cuda").abs()
    grads = {"t": torch.randn((48, 64), generator=gen, device="cuda").t(),
             "e": torch.randn((1, 48), generator=gen, device="cuda").expand(64, 48)}
    norm = Optimizer.global_norm(grads)
    kw = dict(max_norm=1.0, b1=0.9, b2=0.999, eps=1e-8, bc1=0.1, bc2=0.001, step_size=-1e-3)
    for k, g in grads.items():
        assert not g.is_contiguous()
        want = [{"x": t.clone()} for t in (p, m, v)]
        adam.adam_update_plain(want[0], {"x": g}, want[1], want[2], norm, **kw)
        got = [{"x": t.clone()} for t in (p, m, v)]
        adam.adam_update(got[0], {"x": g}, got[1], got[2], norm, **kw)
        for a, b in zip(got, want):
            assert torch.equal(_bits(a["x"]), _bits(b["x"])), k


def test_adam_update_kernel_rejects_what_it_does_not_take(cuda):
    p = {"x": torch.zeros(8, device="cuda", dtype=torch.float16)}
    norm = torch.tensor(1.0, device="cuda")
    kw = dict(max_norm=1.0, b1=0.9, b2=0.999, eps=1e-8, bc1=0.1, bc2=0.001, step_size=-1e-3)
    with pytest.raises(ValueError, match="f32 or bf16"):
        adam.adam_update(p, p, p, p, norm, **kw)
    q = {"x": torch.zeros((8, 8), device="cuda").t()}
    with pytest.raises(ValueError, match="contiguous"):
        adam.adam_update(q, q, q, q, norm, **kw)
    with pytest.raises(ValueError, match="norm"):
        f = {"x": torch.zeros(8, device="cuda")}
        adam.adam_update(f, f, f, f, norm.cpu(), **kw)


def _harvest_tokens(n, S, vocab, seed):
    rng = np.random.default_rng(seed)
    t = rng.integers(3, vocab, size=(n, S), dtype=np.int64)
    t[:, 0] = 2
    for i in range(1, n, 2):
        t[i, int(rng.integers(S // 4, S)):] = 0
    return t


@pytest.mark.parametrize("page", [32, 64])
def test_paged_attention_at_the_harvest_shape(cuda, page):
    """One chunk of 4 documents of 1024 positions at Gemma-2-2B's heads
    (8 query, 4 KV, head_dim 256), bf16, lengths from trailing PAD ids,
    global and windowed (4096 > S: the window never cuts)."""
    gen = torch.Generator(device="cuda").manual_seed(page)
    tokens = _harvest_tokens(4, 1024, 1000, page)
    lengths = valid_lengths(tokens)
    q = torch.randn((4, 1024, 8, 256), generator=gen, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((4, 1024, 4, 256), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    lens = torch.as_tensor(lengths, device="cuda")
    for window in (0, 4096):
        kw = dict(page_size=page, scale=256 ** -0.5, softcap=50.0, window=window)
        got = pa.paged_attention(q, k, v, lens, **kw)
        want = pa.paged_attention_plain(q, k, v, lens, **kw)
        for d, ln in enumerate(lengths):
            x, y = (t[d, :ln].float().reshape(ln, 8, -1) for t in (got, want))
            e = (x - y).abs()
            assert e.max().item() <= 2e-2
            assert (e.amax(-1) / y.abs().amax(-1).clamp_min(1e-30)).max().item() <= 2e-2


SMALL = lm.LMConfig(vocab_size=512, d_model=256, n_layers=4, n_heads=2, n_kv_heads=1,
                    head_dim=128, d_ff=512, sliding_window=128, query_pre_attn_scalar=128.0)


def test_paged_harvest_through_k1_against_its_plain_rerun(cuda):
    """The paged capture of a ragged chunk through K1 (a launch a layer a
    model) against the same capture with the plain attention: relative
    error per source within 2e-2; wrap rows never zero."""
    params = [lm.init_params(SMALL, seed=s, device="cuda") for s in (1, 2)]
    tokens = _harvest_tokens(4, 256, SMALL.vocab_size, 5)
    lengths = valid_lengths(tokens)
    hooks = ["blocks.3.hook_resid_pre"]
    before = pa.paged_attention.by_route["tensor_cores"]
    got = lm.run_with_cache_multi_paged(params, tokens, lengths, SMALL, hooks, page_size=64,
                                        pad_mode="wrap", out_dtype=torch.bfloat16)
    assert pa.paged_attention.by_route["tensor_cores"] == before + 3 * 2
    want = lm.run_with_cache_multi_paged(params, tokens, lengths, SMALL, hooks, page_size=64,
                                         pad_mode="wrap", out_dtype=torch.bfloat16,
                                         attention=pa.paged_attention_plain)
    for s in range(got.shape[2]):
        a, b = got[:, :, s].float(), want[:, :, s].float()
        rel = ((a - b).norm() / b.norm()).item()
        assert rel <= 2e-2, (s, rel)
    assert (got.float().abs().sum(-1) > 0).all()


def test_dispatcher_launches_on_the_buffers_stream(cuda):
    """A buffer built on a side stream: the refill dispatcher's thread
    runs its pumps on that stream (a thread starts on the default one),
    and the overlap buffer serves overlap off's stream bitwise."""
    params = [lm.init_params(SMALL, seed=s, device="cuda") for s in (1, 2)]
    tokens = _harvest_tokens(64, 17, SMALL.vocab_size, 3)
    kw = dict(d_in=256, n_models=2, batch_size=64, buffer_mult=32, seq_len=17,
              model_batch_size=4, norm_calib_batches=2, hook_point="blocks.2.hook_resid_pre",
              seed=3, buffer_device="hbm")
    side = torch.cuda.Stream()
    seen = []
    with torch.cuda.stream(side):
        on = buf.make_buffer(CrossCoderConfig(**kw, refill_overlap="on"), SMALL, params,
                             tokens, device="cuda")
        off = buf.make_buffer(CrossCoderConfig(**kw), SMALL, params, tokens, device="cuda")
        real = on._overlap_pump

        def pump(credit):
            seen.append(torch.cuda.current_stream().cuda_stream)
            real(credit)

        on._overlap_pump = pump
        try:
            for _ in range(24):
                assert torch.equal(on.next_raw().view(torch.int16),
                                   off.next_raw().view(torch.int16))
        finally:
            on.close()
    assert seen and set(seen) == {side.cuda_stream}
