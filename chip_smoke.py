#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``crosscoder_tpu_torch``) on one H100.

``python3 chip_smoke.py`` from the root of a checkout, on a machine with
one NVIDIA Hopper card and the CUDA toolkit:

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles every kernel under ``crosscoder_tpu_torch/csrc/`` with
   ``nvcc`` (one process per source, all at once) into ``build/kernels/``;
3. kernels vs their plain PyTorch versions on the card: ragged paged
   attention at the Gemma-2-2B attention shapes (mixed lengths, bf16 and
   fp32, global and windowed), the fused encoder→TopK bitwise on exact
   integer-valued inputs (planted ties, NaN, -0.0, a width that is not a
   tile multiple, k in {1, 32, 128}) and on random bf16 at the serve shape;
   times each kernel beside its plain version, one library call and the
   card's bound;
4. serve: two random-init Gemma-2-2B models (bf16, seeds 1 and 2) hooked at
   ``blocks.14.hook_resid_pre``, a 16384-latent topk crosscoder (k=32),
   seq_len 1024, page 64, batch 8: warmup, then micro-batches of mixed
   lengths, a partial bucket and one extend, with both kernels' launch
   counters read around the traffic; one batch re-run with both plain
   versions, and one through the padded (page-free) forward;
5. prints the kernel table as one JSON line, the card line, and
   ``{"ok": true, "device": {...}}`` last.

Any failed check exits nonzero before the last line is printed.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

PEAK_BYTES_S = 3.35e12                       # H100 SXM HBM3
PEAK_OPS_S = {"bf16": 989e12, "fp32": 67e12}  # dense tensor-core bf16; fp32 off the tensor cores


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events)."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def bound(n_bytes: float, n_ops: float, dtype: str) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = n_ops / PEAK_OPS_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels vs plain


def check_paged_attention(torch, pa, lengths_serve):
    """K1 at the Gemma-2-2B attention shapes; returns its kernel-table row."""
    D_, S, H, KV, hd, page = 6, 1024, 8, 4, 256, 64
    scale, cap = 256 ** -0.5, 50.0
    gen = torch.Generator(device="cuda").manual_seed(0)
    lens = torch.tensor([1, 63, 64, 65, 1000, 1024], dtype=torch.int32, device="cuda")

    def valid_err(a, b, ln):
        a = a.float().reshape(a.shape[0], S, -1)
        b = b.float().reshape(b.shape[0], S, -1)
        return max(float((a[d, :int(ln[d])] - b[d, :int(ln[d])]).abs().max())
                   for d in range(a.shape[0]))

    for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        q = torch.randn((D_, S, H, hd), generator=gen, device="cuda").to(dt)
        k = torch.randn((D_, S, KV, hd), generator=gen, device="cuda").to(dt)
        v = torch.randn((D_, S, KV, hd), generator=gen, device="cuda").to(dt)
        for window in (4096, 0, 256):
            kw = dict(page_size=page, scale=scale, softcap=cap, window=window)
            got = pa.paged_attention(q, k, v, lens, **kw)
            want = pa.paged_attention_plain(q, k, v, lens, **kw)
            torch.cuda.synchronize()
            err = valid_err(got, want, lens.tolist())
            log(f"K1 paged_attention {str(dt)[6:]} window={window}: max_abs_err={err:.3e} (tol {tol})")
            if not err <= tol:
                fail(f"paged attention kernel disagrees with its plain version: {err} > {tol}")

    # the serve shape: 8 documents of the traffic's first micro-batch, bf16
    D_ = len(lengths_serve)
    lens = torch.tensor(lengths_serve, dtype=torch.int32, device="cuda")
    q = torch.randn((D_, S, H, hd), generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn((D_, S, KV, hd), generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn((D_, S, KV, hd), generator=gen, device="cuda").to(torch.bfloat16)
    kw = dict(page_size=page, scale=scale, softcap=cap, window=0)
    err = valid_err(pa.paged_attention(q, k, v, lens, **kw),
                    pa.paged_attention_plain(q, k, v, lens, **kw), lengths_serve)
    if not err <= 2e-2:
        fail(f"paged attention kernel at the serve shape: {err} > 2e-2")
    ms = time_ms(lambda: pa.paged_attention(q, k, v, lens, **kw), 20)
    plain_ms = time_ms(lambda: pa.paged_attention_plain(q, k, v, lens, **kw), 5)
    pos = torch.arange(S, device="cuda")
    mask = ((pos[None, :, None] >= pos[None, None, :])
            & (pos[None, None, :] < lens[:, None, None].long()))[:, None]    # [D,1,S,S]
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = time_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask, scale=scale, enable_gqa=True), 20)
    n_tok = sum(lengths_serve)
    pairs = sum(t + 1 for ln in lengths_serve for t in range(ln))
    n_bytes = n_tok * (2 * H + 2 * KV) * hd * 2 + D_ * 4
    n_ops = 4 * hd * H * pairs
    b_ms, b_by = bound(n_bytes, n_ops, "bf16")
    log(f"K1 serve shape {D_}x{S} bf16: {ms:.4f} ms kernel, {plain_ms:.4f} ms plain, "
        f"{library_ms:.4f} ms sdpa, bound {b_ms:.4f} ms by {b_by}")
    return {"name": "paged_attention", "route": "cuda",
            "source": "crosscoder_tpu_torch/csrc/paged_attention.cu",
            "replaces": "crosscoder_tpu/ops/paged_attention.py:189",
            "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms}


def _bits(t, torch):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t.view(torch.int32)


def check_fused_topk(torch, fek):
    """K2: bitwise on exact inputs, near-tie agreement on random bf16, and
    the serve-shape timing; returns its kernel-table row."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    B, nd, width = 12, 4608, 2 ** 14 + 96
    for dt in (torch.bfloat16, torch.float32):
        x = torch.randint(-3, 4, (B, nd), generator=gen, device="cuda").float()
        W = torch.randint(-3, 4, (nd, width), generator=gen, device="cuda").float()
        b = torch.randint(-8, 9, (width,), generator=gen, device="cuda").float()
        W[:, 100:164] = W[:, 36:100]          # duplicate columns: exact ties
        W[:, 5000] = W[:, 7]
        b[5000] = b[7]
        x[1] = float("nan")                   # a NaN row: every slot NaN, nothing emitted
        x[2] = -0.0                           # a -0.0 row against -0.0 and NaN biases
        b[200] = -0.0
        b[300] = float("nan")                 # a NaN column: takes a slot, dropped at emit
        x[3] = 0.0
        x, W = x.to(dt), W.to(dt)
        for k in (1, 32, 128):
            vk, ik = fek.fused_topk_encode(x, W, b, k)
            vp, ip = fek.fused_topk_encode_plain(x, W, b, k)
            torch.cuda.synchronize()
            same = torch.equal(_bits(vk, torch), _bits(vp, torch)) and torch.equal(ik, ip)
            log(f"K2 fused_topk exact {str(dt)[6:]} k={k}: bitwise {'equal' if same else 'DIFFERENT'}")
            if not same:
                bad = (ik != ip).any(dim=1).nonzero().flatten().tolist()
                fail(f"fused topk kernel not bitwise equal to its plain version (rows {bad})")

    # random bf16 at the serve shape: index sets agree up to near-ties
    B, width, k = 8, 2 ** 14, 32
    W = (torch.randn((nd, width), generator=gen, device="cuda") * nd ** -0.5).to(torch.bfloat16)
    b = torch.zeros(width, device="cuda", dtype=torch.bfloat16)
    rows = agree = 0
    err = 0.0
    for _ in range(8):
        x = torch.randn((B, nd), generator=gen, device="cuda").to(torch.bfloat16)
        vk, ik = fek.fused_topk_encode(x, W, b, k)
        vp, ip = fek.fused_topk_encode_plain(x, W, b, k)
        hf = torch.matmul(x.float(), W.float()) + b.float()
        for r in range(B):
            rows += 1
            sk, sp = set(ik[r].tolist()), set(ip[r].tolist())
            if sk == sp:
                agree += 1
                err = max(err, float((vk[r].float() - vp[r].float()).abs().max()))
                continue
            for i in sk - sp:
                for j in sp - sk:
                    a, c = float(hf[r, i]), float(hf[r, j])
                    ulp = 2.0 ** (math.floor(math.log2(max(abs(a), abs(c), 1e-30))) - 7)
                    if abs(a - c) > ulp:
                        fail(f"fused topk row {r}: latents {i} and {j} differ by "
                             f"{abs(a - c)} > 1 bf16 ulp ({ulp}) yet only one was selected")
    log(f"K2 fused_topk random bf16 [{B},{nd}]x[{nd},{width}] k={k}: index sets agree on "
        f"{agree}/{rows} rows, every other row a near-tie; max |dvals| on agreeing rows {err:.3e}")

    ms = time_ms(lambda: fek.fused_topk_encode(x, W, b, k), 50)
    plain_ms = time_ms(lambda: fek.fused_topk_encode_plain(x, W, b, k), 10)
    library_ms = time_ms(lambda: torch.topk(torch.matmul(x, W), k), 50)
    n_bytes = x.numel() * 2 + W.numel() * 2 + width * 4 + B * k * (2 + 4)
    b_ms, b_by = bound(n_bytes, 2 * B * nd * width, "bf16")
    log(f"K2 serve shape: {ms:.4f} ms kernel, {plain_ms:.4f} ms plain, "
        f"{library_ms:.4f} ms matmul+topk, bound {b_ms:.4f} ms by {b_by}")
    return {"name": "fused_topk_encode", "route": "cuda",
            "source": "crosscoder_tpu_torch/csrc/fused_topk.cu",
            "replaces": "crosscoder_tpu/ops/fused_encoder_topk.py:353",
            "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms}


# ---------------------------------------------------------------------------
# phase 4: serve


def check_result(r, k: int, width: int) -> None:
    import numpy as np

    if r.vals.shape != (k,) or r.idx.shape != (k,) or r.diff.shape != (k,):
        fail(f"request {r.request_id}: shapes {r.vals.shape} {r.idx.shape} {r.diff.shape}")
    if not (np.isfinite(r.vals).all() and np.isfinite(r.diff).all()):
        fail(f"request {r.request_id}: non-finite output")
    n = int((r.vals != 0).sum())
    if n == 0 or (r.vals[n:] != 0).any() or (r.idx[n:] != 0).any():
        fail(f"request {r.request_id}: emitted slots not a (0, 0)-padded prefix")
    if not ((r.idx[:n] >= 0).all() and (r.idx[:n] < width).all()
            and (np.diff(r.idx[:n]) > 0).all()):
        fail(f"request {r.request_id}: idx not ascending in [0, {width})")
    if not ((r.diff >= 0).all() and (r.diff <= 1).all()):
        fail(f"request {r.request_id}: diff outside [0, 1]")


def overlap(vals_a, idx_a, vals_b, idx_b) -> float:
    """Jaccard overlap of two rows' emitted latent sets."""
    sa, sb = set(idx_a[vals_a != 0].tolist()), set(idx_b[vals_b != 0].tolist())
    return len(sa & sb) / max(1, len(sa | sb))


def profile_batch(torch, eng, smoke, docs) -> None:
    """Device time by kernel for one full micro-batch (``torch.profiler``),
    grouped into the two ported kernels, matmuls and the rest."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    smoke.serve_batch(eng, docs)
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        smoke.serve_batch(eng, docs)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        t = getattr(e, "self_device_time_total", None)
        return t if t is not None else getattr(e, "self_cuda_time_total", 0)

    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total = sum(dev_us(e) for e in kernels) / 1e3
    if total <= 0:
        log("profile: the profiler recorded no device time (not measured)")
        return
    groups = {"paged_attention (K1)": 0.0, "fused_topk (K2)": 0.0, "matmul": 0.0, "other": 0.0}
    for e in kernels:
        n = e.key.lower()
        g = ("paged_attention (K1)" if "rpa_kernel" in n else
             "fused_topk (K2)" if "topk_tiles" in n or "topk_merge" in n else
             "matmul" if any(t in n for t in ("gemm", "xmma", "cutlass", "nvjet", "cublas"))
             else "other")
        groups[g] += dev_us(e) / 1e3
    log(f"profile: one micro-batch of {len(docs)} requests: {wall_ms:.3f} ms wall unprofiled, "
        f"{prof_wall_ms:.3f} ms profiled, {total:.3f} ms device busy "
        f"({100 * total / prof_wall_ms:.1f}% of the profiled wall)")
    for g, ms in groups.items():
        log(f"profile:   {g}: {ms:.3f} ms ({100 * ms / total:.1f}% of device time)")
    for e in sorted(kernels, key=dev_us, reverse=True)[:8]:
        log(f"profile:   {dev_us(e) / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}")


def serve(torch, np, lengths_a):
    from crosscoder_tpu_torch.models import lm
    from crosscoder_tpu_torch.ops import fused_encoder_topk as fek
    from crosscoder_tpu_torch.ops import paged_attention as pa
    from crosscoder_tpu_torch.serve import smoke

    t0 = time.perf_counter()
    eng, cfg, lm_cfg, _, _ = smoke.build_engine(
        serve_max_batch=8, seq_len=1024, lm_cfg=lm.LMConfig.gemma2_2b(),
        hook_points=("blocks.14.hook_resid_pre",), device="cuda", seeds=(1, 2, 3),
        dict_size=2 ** 14, topk_k=32, page_size=64, enc_dtype="bf16")
    torch.cuda.synchronize()
    log(f"serve: two random-init Gemma-2-2B (bf16) + crosscoder 16384x{cfg.topk_k} built "
        f"in {time.perf_counter() - t0:.1f} s; {torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
    t0 = time.perf_counter()
    eng.warmup()
    log(f"serve: warmup of buckets {eng.buckets} in {time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(5)
    V = lm_cfg.vocab_size

    def docs_of(lengths):
        return [rng.integers(1, V, size=int(n), dtype=np.int32) for n in lengths]

    batch_a = docs_of(lengths_a)
    more = [docs_of(rng.integers(1, 1025, size=8)) for _ in range(3)]
    partial = docs_of([700, 33, 1])
    keep_doc, extra = docs_of([400, 212])

    pa.paged_attention.launches = 0
    fek.fused_topk_encode.launches = 0
    served = [smoke.serve_batch(eng, batch_a)]
    served += [smoke.serve_batch(eng, d) for d in more]
    served.append(smoke.serve_batch(eng, partial))
    rid = eng.submit(keep_doc, keep=True)
    served.append(eng.step(force=True))
    eng.extend(rid, extra)
    ext = eng.step(force=True)
    served.append(ext)
    eng.release(rid)
    torch.cuda.synchronize()
    launches = {"paged_attention": pa.paged_attention.launches,
                "fused_topk_encode": fek.fused_topk_encode.launches}
    log(f"serve: {sum(len(s) for s in served)} requests in {len(served)} micro-batches; "
        f"kernel launches {launches}")
    if not all(launches.values()):
        fail(f"a kernel of the serve path never launched: {launches}")
    if [r.bucket for r in served[4]] != [4, 4, 4]:
        fail(f"partial batch of 3 served under buckets {[r.bucket for r in served[4]]}")
    if not (len(ext) == 1 and ext[0].extended):
        fail("the extend ticket was not served")
    for batch in served:
        for r in batch:
            check_result(r, cfg.topk_k, cfg.dict_size)

    # batch A again with both plain versions, same device, same packing
    vals_p, idx_p, diff_p, last_p = smoke.serve_plain(eng, batch_a)
    last_k = smoke.serve_docs(eng, batch_a)[3].float()
    rel = float(torch.linalg.norm(last_k - last_p.float()) / torch.linalg.norm(last_p.float()))
    ov = [overlap(r.vals, r.idx, vals_p[i], idx_p[i]) for i, r in enumerate(served[0])]
    log(f"serve vs plain re-run (batch A, lengths {list(lengths_a)}): last-token activation "
        f"relative error {rel:.3e} (tol 5e-2); latent-set overlap mean {np.mean(ov):.3f} "
        f"min {min(ov):.3f} (tol mean >= 0.75)")
    if not (rel <= 5e-2 and np.mean(ov) >= 0.75):
        fail("serve path disagrees with its plain re-run beyond the bf16 tolerance")
    for i, r in enumerate(served[0]):
        common = np.intersect1d(r.idx[r.vals != 0], idx_p[i][vals_p[i] != 0])
        a = r.vals[np.searchsorted(r.idx[r.vals != 0], common)]
        c = vals_p[i][np.searchsorted(idx_p[i][vals_p[i] != 0], common)]
        if not np.allclose(a, c, rtol=5e-2, atol=5e-2 * float(np.abs(c).max())):
            fail(f"request {i}: vals on shared latents differ beyond rtol 5e-2")
        d_a = r.diff[np.searchsorted(r.idx[r.vals != 0], common)]
        d_c = diff_p[i][np.searchsorted(idx_p[i][vals_p[i] != 0], common)]
        if not np.array_equal(d_a, d_c):
            fail(f"request {i}: diff scores on shared latents differ")

    # the partial batch against the padded (page-free) forward
    toks = np.zeros((3, cfg.seq_len), np.int64)
    for i, d in enumerate(partial):
        toks[i, : len(d)] = d
    vals_o, idx_o, _ = smoke.oracle(eng, toks, [len(d) for d in partial])
    ov_o = [overlap(r.vals, r.idx, vals_o[i], idx_o[i]) for i, r in enumerate(served[4])]
    log(f"serve vs padded forward (partial batch): latent-set overlap {ov_o} (tol mean >= 0.75)")
    if np.mean(ov_o) < 0.75:
        fail("paged serve path disagrees with the padded forward")
    profile_batch(torch, eng, smoke, batch_a)
    st = eng.stats()
    log(f"serve: prefill p50 {st['serve/prefill_ms_p50']:.3f} ms, encode p50 "
        f"{st['serve/encode_ms_p50']:.3f} ms over {st['serve/prefill_ms_n']} micro-batches "
        f"(warmup included)")
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: chip_smoke drives the port on the card")
    root = Path(__file__).resolve().parent
    if not (root / "crosscoder_tpu_torch" / "__init__.py").is_file():
        fail(f"crosscoder_tpu_torch not found beside {Path(__file__).name}")
    sys.path.insert(0, str(root))
    import numpy as np

    from crosscoder_tpu_torch.ops import _build
    from crosscoder_tpu_torch.ops import fused_encoder_topk as fek
    from crosscoder_tpu_torch.ops import paged_attention as pa

    # parity is measured in full fp32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)} ({card}); torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"build: {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    rng = np.random.default_rng(3)
    lengths_a = [1, 1024] + [int(n) for n in rng.integers(2, 1024, size=6)]
    rows = [check_paged_attention(torch, pa, lengths_a), check_fused_topk(torch, fek)]
    launches = serve(torch, np, lengths_a)
    for row in rows:
        row["launches"] = launches[row["name"]]
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
