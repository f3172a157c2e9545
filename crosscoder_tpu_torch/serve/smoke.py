"""A serving stack from random weights, and the references it is held to.

Shared by the tests (tiny shapes on the CPU) and ``chip_smoke.py`` (the
full Gemma-2-2B pair on the card):

- :func:`build_engine`: two random-init LMs (distinct seeds), a topk
  crosscoder, an :class:`InferenceEngine`;
- :func:`serve_batch`: submit documents, force one flush, results in
  submit order;
- :func:`oracle`: the padded capture forward + the encode step, the
  offline answer the paged serve path must match;
- :func:`serve_docs` / :func:`serve_plain`: the engine's own paged path
  for one bucket, with the kernels or with both swapped for their plain
  PyTorch versions.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.data.paging import pack_chunk
from crosscoder_tpu_torch.models import crosscoder, lm
from crosscoder_tpu_torch.ops import fused_encoder_topk as fek
from crosscoder_tpu_torch.ops import paged_attention as pa
from crosscoder_tpu_torch.serve import step as serve_step
from crosscoder_tpu_torch.serve.engine import InferenceEngine, bucket_of
from crosscoder_tpu_torch.utils.device import resolve_device

TINY_HOOKS = ("blocks.1.hook_resid_pre", "blocks.3.hook_resid_pre")


def build_engine(serve_max_batch: int = 8, seq_len: int = 16,
                 clock=time.monotonic, *, lm_cfg: lm.LMConfig | None = None,
                 hook_points=TINY_HOOKS, device=None, seeds=(1, 2, 3),
                 **cfg_overrides):
    """``(engine, cfg, lm_cfg, lm_params, cc_params)``: models from
    ``seeds[0]`` and ``seeds[1]``, crosscoder from ``seeds[2]``. Defaults
    are the tiny test stack; ``cfg_overrides`` land on the config."""
    lm_cfg = lm.LMConfig.tiny() if lm_cfg is None else lm_cfg
    dev = resolve_device(device)
    params = [lm.init_params(lm_cfg, seed=s, device=dev) for s in seeds[:2]]
    kw = dict(
        d_in=lm_cfg.d_model, dict_size=64, batch_size=serve_max_batch,
        enc_dtype=lm_cfg.dtype, activation="topk", topk_k=4, n_models=2,
        hook_points=tuple(hook_points), seq_len=seq_len, page_size=8,
        serve="on", serve_max_batch=serve_max_batch, serve_max_wait_ms=2.0,
        serve_queue=4 * serve_max_batch, log_backend="null", seed=7,
    )
    kw.update(cfg_overrides)
    cfg = CrossCoderConfig(**kw)
    cc_params = crosscoder.init_params(cfg, seed=seeds[2], device=dev)
    eng = InferenceEngine(cfg, lm_cfg, params, cc_params, clock=clock, device=dev)
    return eng, cfg, lm_cfg, params, cc_params


def serve_batch(eng: InferenceEngine, docs, *, keep: bool = False):
    rids = [eng.submit(d, keep=keep) for d in docs]
    results = eng.step(force=True)
    got = {r.request_id: r for r in results}
    return [got[r] for r in rids]


def _host(out):
    vals, idx, diff = out
    return vals.float().cpu().numpy(), idx.cpu().numpy(), diff.float().cpu().numpy()


def oracle(eng: InferenceEngine, tokens, lengths):
    """Padded-path reference for a request batch ``tokens [B, S]`` +
    ``lengths [B]``: host ``(vals, idx, diff)``."""
    cfg = eng.cfg
    caps = lm.run_with_cache_multi(
        eng._lm_params, torch.as_tensor(np.asarray(tokens, np.int64), device=eng.device),
        eng.lm_cfg, eng._hooks)
    return _host(serve_step.encode_topk_diff(
        eng._cc_params, caps, torch.as_tensor(np.asarray(lengths), device=eng.device),
        eng._norm, enc_dtype=cfg.enc_dtype, k=cfg.topk_k, pair=eng._pair))


def serve_docs(eng: InferenceEngine, docs, *, attention=pa.paged_attention,
               encode=fek.fused_topk_encode):
    """``docs`` packed as the engine packs one micro-batch (bucket padding
    included) and run through the engine's paged path with the given
    attention and encoder→TopK (the kernels by default; pass their plain
    versions to re-run the path without them): host ``(vals, idx, diff)``
    for the real docs, plus their last-token activations ``[n, n_src, d]``
    on the device."""
    cfg = eng.cfg
    n = len(docs)
    b = bucket_of(n, cfg.serve_max_batch)
    docs = list(docs) + [np.zeros(1, np.int32)] * (b - n)
    tokens = np.zeros((b, cfg.seq_len), np.int32)
    for i, d in enumerate(docs):
        tokens[i, : len(d)] = d
    chunk = pack_chunk(tokens, np.asarray([len(d) for d in docs]), n_rows=b)
    caps = lm.paged_capture(eng._lm_params, chunk, eng.lm_cfg, eng._hooks,
                            page_size=cfg.page_size, attention=attention)
    lengths = torch.as_tensor(chunk.lengths, device=eng.device)
    vals, idx, diff = _host(serve_step.encode_topk_diff(
        eng._cc_params, caps, lengths, eng._norm, enc_dtype=cfg.enc_dtype,
        k=cfg.topk_k, pair=eng._pair, encode=encode))
    last = caps[torch.arange(b, device=eng.device), lengths.long() - 1]
    return vals[:n], idx[:n], diff[:n], last[:n]


def serve_plain(eng: InferenceEngine, docs):
    """:func:`serve_docs` with both kernels swapped for their plain
    PyTorch versions."""
    return serve_docs(eng, docs, attention=pa.paged_attention_plain,
                      encode=fek.fused_topk_encode_plain)
