"""Air-gapped demonstration harness, ported from :mod:`crosscoder_tpu.demo`:
a deterministic synthetic-language LM pair and a crosscoder trained on
their paired activations.

Two tiny LMs learn the same fully predictable language (model B a
fine-tune of A on a shifted mix of it), so their residual streams carry
real, partially shared structure, and the crosscoder trains on the real
harvest → buffer → trainer path. :mod:`crosscoder_tpu_torch.replicate`
``--demo`` runs the analysis stack on top. Every function takes
``device=`` and runs on ``cuda`` unless it names another device. The
token corpus is bitwise the JAX package's; the weights come from
PyTorch's generator, so they are not.
"""

from __future__ import annotations

import numpy as np
import torch

# deterministic synthetic language: x_{t+1} = (5·x_t + 17) mod V with a
# random start token, fully predictable from the current token, so a tiny
# LM learns it and a mid-stack ablation has a large, real CE cost
DEMO_VOCAB = 257
DEMO_SEQ_LEN = 33
DEMO_HOOK = "blocks.2.hook_resid_pre"


def synthetic_language_tokens(n_seqs: int = 512, seq_len: int = DEMO_SEQ_LEN,
                              vocab: int = DEMO_VOCAB, seed: int = 11,
                              frac_alt: float = 0.0) -> np.ndarray:
    """``[n_seqs, seq_len]`` int64 tokens; ``frac_alt`` of the sequences
    (deterministically interleaved) follow a second affine rule, x→7x+3
    instead of x→5x+17: the demo's "instruction-tuning" shift."""
    rng = np.random.default_rng(seed)
    tokens = np.zeros((n_seqs, seq_len), dtype=np.int64)
    tokens[:, 0] = rng.integers(0, vocab, size=n_seqs)
    alt = (np.arange(n_seqs) % 10) < round(frac_alt * 10)
    for t in range(1, seq_len):
        x = tokens[:, t - 1]
        tokens[:, t] = np.where(alt, (7 * x + 3) % vocab, (5 * x + 17) % vocab)
    return tokens


def train_tiny_lm(seed: int, lm_cfg, tokens: np.ndarray, steps: int, lr: float = 3e-3,
                  init_params=None, device=None):
    """Adam (optax's defaults: betas 0.9/0.999, eps 1e-8) on the mean
    next-token CE through :func:`lm.forward` + :func:`lm.loss_fn`, batches
    of 16 sequences in order. ``init_params`` continues from existing
    weights (the fine-tune), else a random init from ``seed``. Returns
    ``(params, final CE)``."""
    from crosscoder_tpu_torch.models import lm

    if steps < 1:
        raise ValueError("steps must be >= 1")
    if init_params is None:
        init_params = lm.init_params(lm_cfg, seed=seed, device=device)

    def trainable(t):
        return t.detach().clone().requires_grad_(True)

    params = {"embed": trainable(init_params["embed"]),
              "final_norm": trainable(init_params["final_norm"]),
              "layers": {k: trainable(v) for k, v in init_params["layers"].items()}}
    opt = torch.optim.Adam([params["embed"], params["final_norm"], *params["layers"].values()],
                           lr=lr, betas=(0.9, 0.999), eps=1e-8)
    dev = params["embed"].device
    n = tokens.shape[0]
    for i in range(steps):
        batch = torch.as_tensor(tokens[(i * 16) % n:(i * 16) % n + 16], device=dev)
        logits, _ = lm.forward(params, batch, lm_cfg)
        loss = lm.loss_fn(logits, batch)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    return ({"embed": params["embed"].detach(), "final_norm": params["final_norm"].detach(),
             "layers": {k: v.detach() for k, v in params["layers"].items()}},
            float(loss.detach()))


def build_demo_pair(lm_steps: int = 400, device=None):
    """``(lm_cfg, [params_A, params_B], tokens, train CEs)``. Model B is a
    fine-tune of A on a shifted language (a second affine rule mixed in),
    as the reference's base-vs-IT pair shares a residual basis; the tokens
    are the 70/30 mixed corpus both the harvest and the eval use."""
    from crosscoder_tpu_torch.models import lm

    base_tokens = synthetic_language_tokens(frac_alt=0.0)
    tune_tokens = synthetic_language_tokens(seed=12, frac_alt=1.0)
    mixed_tokens = synthetic_language_tokens(seed=13, frac_alt=0.3)
    lm_cfg = lm.LMConfig.tiny(vocab_size=DEMO_VOCAB)
    pa, la = train_tiny_lm(0, lm_cfg, base_tokens, lm_steps, device=device)
    # a gentle fine-tune (lower lr, fewer steps): B learns rule 2 while
    # keeping A's residual basis, which the shared latents' cosines need
    pb, lb = train_tiny_lm(1, lm_cfg, tune_tokens, max(1, lm_steps // 3), lr=1e-3,
                           init_params=pa, device=device)
    return lm_cfg, [pa, pb], mixed_tokens, {
        "A": la, "B": lb, "uniform": float(np.log(DEMO_VOCAB))}


def train_demo_crosscoder(lm_cfg, model_params, tokens: np.ndarray, cc_steps: int = 1500,
                          device=None):
    """A crosscoder trained on the demo pair through the real pipeline
    (:func:`make_buffer` harvest → :class:`Trainer`, one device). Returns
    ``(cc_params, cfg, normalisation factors, final metrics)``."""
    from crosscoder_tpu_torch.config import CrossCoderConfig
    from crosscoder_tpu_torch.data.buffer import make_buffer
    from crosscoder_tpu_torch.train.trainer import Trainer

    cfg = CrossCoderConfig(
        d_in=lm_cfg.d_model, dict_size=1024, batch_size=256, buffer_mult=64,
        seq_len=tokens.shape[1], model_batch_size=16, norm_calib_batches=4,
        hook_point=DEMO_HOOK, num_tokens=256 * cc_steps,
        enc_dtype="fp32", l1_coeff=0.3, lr=1e-3, log_backend="null",
        checkpoint_dir="", save_every=10**9,
    )
    buffer = make_buffer(cfg, lm_cfg, model_params, tokens, device=device)
    trainer = Trainer(cfg, buffer, device=device)
    final = trainer.train()
    params = {k: v.detach() for k, v in trainer.state.params.items()}
    return params, cfg, np.asarray(buffer.normalisation_factor), final
