"""JumpReLU θ warm-start, ported from :mod:`crosscoder_tpu.train.warmstart`:
a trained TopK/BatchTopK crosscoder becomes a JumpReLU init whose
threshold starts at the k-sparse regime.

Training JumpReLU with the L0 objective from the default θ = 0.001 moves
the threshold too slowly to reach L0 ≈ k; starting ``log_theta`` at the
BatchTopK threshold calibrated on the trained weights does. The recipe:

    cfg1 = cfg.replace(activation="batchtopk", topk_k=K, l1_coeff=0.0)
    ...train...
    cfg2 = cfg.replace(activation="jumprelu", l0_coeff=1.0, jumprelu_bandwidth=0.03)
    params2 = jumprelu_warmstart_params(tr.state.params, cfg1, cfg2, batches)
    tr2 = Trainer(cfg2, ..., state=TrainState(params2, opt.init(params2), 0, None))
"""

from __future__ import annotations

import torch

from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.models import crosscoder as cc


@torch.no_grad()
def jumprelu_warmstart_params(params: cc.Params, cfg_from: CrossCoderConfig,
                              cfg_to: CrossCoderConfig, batches) -> cc.Params:
    """Trained TopK/BatchTopK params → JumpReLU params with a calibrated θ.

    ``batches``: a few ``[B, n_sources, d_in]`` activation batches,
    normalized as training batches were; θ is their mean per-batch
    BatchTopK threshold at ``cfg_from.topk_k``
    (:func:`crosscoder.calibrate_batchtopk_threshold`). The weight leaves
    carry over (the same tensors); ``log_theta`` is ``log(θ)`` in f32 for
    every latent, on the weights' device. The caller starts a fresh
    optimizer state."""
    if cfg_to.activation != "jumprelu":
        raise ValueError(f"cfg_to.activation must be 'jumprelu', got {cfg_to.activation!r}")
    if cfg_from.activation not in ("topk", "batchtopk"):
        raise ValueError("warm-start calibrates a TopK-order-statistic threshold; "
                         f"cfg_from.activation must be topk|batchtopk, got "
                         f"{cfg_from.activation!r}")
    n, d_in, h = params["W_enc"].shape
    if (h, d_in, n) != (cfg_to.dict_size, cfg_to.d_in, cfg_to.n_sources):
        raise ValueError(
            f"trained params are dict_size={h}, d_in={d_in}, n_sources={n} but cfg_to expects "
            f"{cfg_to.dict_size}/{cfg_to.d_in}/{cfg_to.n_sources} — the transplant carries the "
            "weights, so the target config must match their shapes")
    thresh = cc.calibrate_batchtopk_threshold(params, cfg_from, batches)
    if thresh <= 0:
        raise ValueError(f"calibrated threshold {thresh} <= 0 (all pre-acts non-positive on "
                         "the calibration batches?) — cannot initialize log_theta")
    out = {k: v for k, v in params.items() if k != "log_theta"}
    log_t = torch.log(torch.tensor(thresh, dtype=torch.float32))
    out["log_theta"] = torch.full((cfg_to.dict_size,), float(log_t), dtype=torch.float32,
                                  device=params["W_enc"].device)
    return out
