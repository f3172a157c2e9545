"""Feature-centric latent dashboards, ported from
:mod:`crosscoder_tpu.analysis.dashboards` (the reference's sae_vis fork,
nb:cells 33-42): per latent, the top activating sequences as token
heatmaps, sequences from equal-width value bands below them, the
activation distribution, the decoder-geometry stats and a logit lens,
written as one self-contained HTML file
(``FeatureVisData.create(...).save_feature_centric_vis(path)``).

Latent activations come from both models' hook rows
(:func:`crosscoder_tpu_torch.models.lm.run_with_cache_multi`, BOS
dropped) through the crosscoder's ``encode`` on f32 rows flattened to
``[B·(S-1), n, d]``; on the card the encode runs the TopK mask kernel of
its route (K6 for f32 rows at a 2^14-latent dictionary). Minibatches of
sequences stay in flight while the host reads earlier ones
(:func:`crosscoder_tpu_torch.utils.pipeline.drive`). The crosscoder must be
the folded one when the rows are raw.
"""

from __future__ import annotations

import html as _html
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Sequence

import numpy as np
import torch

from crosscoder_tpu_torch.analysis import decoder as dec_analysis
from crosscoder_tpu_torch.analysis.plots import (
    default_token_renderer,
    svg_histogram,
    tokens_to_html,
)
from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.models import crosscoder as cc
from crosscoder_tpu_torch.models import lm
from crosscoder_tpu_torch.utils import pipeline


@dataclass
class FeatureVisConfig:
    """Mirrors the knobs the notebook sets on the sae_vis fork (nb:cell 36)."""

    hook_point: str
    features: tuple[int, ...]
    minibatch_size_tokens: int = 4       # sequences per harvest forward
    top_k_sequences: int = 8             # heatmap rows per feature
    window: int = 24                     # tokens shown around the peak
    logit_lens_k: int = 10               # promoted/suppressed tokens per table
    include_logit_lens: bool = True      # the fork's logit tables (nb:cells 33-42)
    # sae_vis-style interval sequence groups (nb:cells 36-42): besides the
    # top-k max-activating group, sample sequences whose PEAK activation
    # falls in each of n EQUAL-WIDTH value bands of (0, max_act] — the
    # mid/low-strength firing contexts a top-k-only view hides. (Named for
    # what it builds: value intervals, not sae_vis's equal-count rank
    # quantiles.) 0 disables.
    n_interval_groups: int = 4
    seqs_per_group: int = 4

    def __post_init__(self) -> None:
        self.features = tuple(int(f) for f in self.features)


@dataclass
class FeatureData:
    feature: int
    max_act: float
    frac_active: float                   # fraction of tokens with act > 0
    relative_norm: float                 # r of this latent (analysis.py:12)
    cosine_sim: float
    acts_sample: np.ndarray              # nonzero activations (density plot)
    top_seqs: list[dict] = field(default_factory=list)
    # each: {tokens: [int], values: [float], peak: int}
    interval_groups: list[dict] = field(default_factory=list)
    # each: {label: str, lo: float, hi: float, seqs: [same dicts as top_seqs]}
    logit_lens: list[dict] = field(default_factory=list)
    # per source: {source: int, promoted: [(token_id, value)...],
    #              suppressed: [(token_id, value)...]} — the sae_vis fork's
    # top promoted/suppressed output-token tables (nb:cells 33-42)


@torch.no_grad()
def _latent_acts(model_params, cc_params, feats: torch.Tensor, tokens: torch.Tensor,
                 lm_cfg: lm.LMConfig, hook_point: str, cc_cfg: CrossCoderConfig
                 ) -> torch.Tensor:
    """The selected latents' activations for one token minibatch
    ``[B, S-1, n_feats]``, on the device."""
    x = lm.run_with_cache_multi(model_params, tokens, lm_cfg, (hook_point,))[:, 1:]
    B, Sm1, n, d = x.shape
    f = cc.encode(cc_params, x.reshape(B * Sm1, n, d).float(), cc_cfg)
    return f[:, feats].reshape(B, Sm1, -1)


@torch.no_grad()
def _logit_lens_topk(w_sel: torch.Tensor, embed: torch.Tensor, w_final: torch.Tensor, k: int):
    """Linear logit lens of decoder directions through one model's head:
    direction → final-RMSNorm scale ``(1+w)`` → tied unembedding, in f32.
    Returns (top values, top ids, bottom values, bottom ids), each ``[F,
    L, k]``. The RMS scalar and the final softcap are monotone per
    position, so they cannot change the ranking; values are the
    pre-softcap linear effects."""
    F, L, d = w_sel.shape
    dirs = w_sel.float() * (1.0 + w_final.float())
    logits = (dirs.reshape(F * L, d) @ embed.float().t()).reshape(F, L, -1)
    top_v, top_i = torch.topk(logits, k, dim=-1)
    bot_v, bot_i = torch.topk(-logits, k, dim=-1)
    return top_v, top_i, -bot_v, bot_i


def _compute_logit_lens(cc_params, cc_cfg: CrossCoderConfig, model_params,
                        features: tuple[int, ...], k: int) -> list[list[dict]]:
    """Per feature, per source: the top-k promoted and suppressed output
    tokens."""
    n_hooks = cc_cfg.n_sources // cc_cfg.n_models
    w_dec = cc_params["W_dec"][torch.as_tensor(features, device=cc_params["W_dec"].device)]
    per_feature: list[list[dict]] = [[] for _ in features]
    for m, p in enumerate(model_params):
        sel = w_dec[:, m * n_hooks:(m + 1) * n_hooks].to(p["embed"].device)   # [F, L, d]
        tv, ti, bv, bi = (t.cpu().numpy() for t in
                          _logit_lens_topk(sel, p["embed"], p["final_norm"], k))
        for fi in range(len(features)):
            for li in range(n_hooks):
                per_feature[fi].append({
                    "source": m * n_hooks + li,
                    "promoted": list(zip(ti[fi, li].tolist(), tv[fi, li].tolist())),
                    "suppressed": list(zip(bi[fi, li].tolist(), bv[fi, li].tolist())),
                })
    return per_feature


class FeatureVisData:
    """Computed dashboard data; render with ``save_feature_centric_vis``."""

    def __init__(self, vis_cfg: FeatureVisConfig, features: list[FeatureData]) -> None:
        self.cfg = vis_cfg
        self.features = features

    @classmethod
    def create(cls, cc_params: cc.Params, cc_cfg: CrossCoderConfig, lm_cfg: lm.LMConfig,
               model_params: Sequence[lm.LMParams], tokens: np.ndarray,
               vis_cfg: FeatureVisConfig) -> "FeatureVisData":
        """The dashboards' data for ``vis_cfg.features`` over ``tokens
        [N, S]`` (numpy), the models and the crosscoder on their device."""
        dev = model_params[0]["embed"].device
        feats = torch.as_tensor(vis_cfg.features, device=dev)
        rel = dec_analysis.relative_norms(cc_params).cpu().numpy()[list(vis_cfg.features)]
        cos = dec_analysis.cosine_sims(cc_params).cpu().numpy()[list(vis_cfg.features)]

        tokens = np.asarray(tokens)
        mb = vis_cfg.minibatch_size_tokens
        # a few minibatches in flight: the card runs ahead of the host's reads
        all_acts: list = []
        pipeline.drive(
            (_latent_acts(model_params, cc_params, feats,
                          torch.as_tensor(tokens[s:s + mb], device=dev).long(), lm_cfg,
                          vis_cfg.hook_point, cc_cfg)
             for s in range(0, tokens.shape[0], mb)),
            lambda a: all_acts.append(a.cpu().numpy()),
        )
        acts = np.concatenate(all_acts)                     # [N, S-1, n_feats]

        lens_tables: list[list[dict]] = [[] for _ in vis_cfg.features]
        if vis_cfg.include_logit_lens:
            lens_tables = _compute_logit_lens(
                cc_params, cc_cfg, model_params, vis_cfg.features,
                vis_cfg.logit_lens_k,
            )

        out = []
        for fi, feat in enumerate(vis_cfg.features):
            a = acts[..., fi]                               # [N, S-1]
            peak_per_seq = a.max(axis=1)

            def seq_entry(si: int) -> dict:
                peak = int(a[si].argmax())
                lo = max(0, peak + 1 - vis_cfg.window // 2)
                hi = min(tokens.shape[1], lo + vis_cfg.window)
                return {
                    # +1: activation col j scores token j+1 (BOS dropped)
                    "tokens": tokens[si, lo:hi].tolist(),
                    "values": np.concatenate([[0.0], a[si]])[lo:hi].tolist(),
                    "peak": peak + 1 - lo,
                }

            order = np.argsort(-peak_per_seq)[: vis_cfg.top_k_sequences]
            seqs = [seq_entry(si) for si in order if peak_per_seq[si] > 0]

            # interval groups: equal value-bands of (0, max_act]; within a
            # band, sequences are sampled evenly across the band's sorted
            # peaks (deterministic, spans the band instead of hugging its
            # top edge), excluding anything already shown in the top-k group
            groups: list[dict] = []
            mx = float(a.max())
            if vis_cfg.n_interval_groups > 0 and mx > 0:
                shown = set(int(si) for si in order)
                edges = np.linspace(0.0, mx, vis_cfg.n_interval_groups + 1)
                for j in range(vis_cfg.n_interval_groups - 1, -1, -1):
                    band = np.where(
                        (peak_per_seq > edges[j]) & (peak_per_seq <= edges[j + 1])
                    )[0]
                    band = np.asarray(
                        [si for si in band[np.argsort(-peak_per_seq[band])]
                         if int(si) not in shown]
                    )
                    if band.size == 0:
                        continue
                    take = min(vis_cfg.seqs_per_group, band.size)
                    sel = band[np.unique(
                        np.linspace(0, band.size - 1, take).astype(int)
                    )]
                    groups.append({
                        "label": f"interval {edges[j]:.2f}-{edges[j + 1]:.2f}",
                        "lo": float(edges[j]),
                        "hi": float(edges[j + 1]),
                        "seqs": [seq_entry(int(si)) for si in sel],
                    })
            nz = a[a > 0]
            out.append(FeatureData(
                feature=int(feat),
                max_act=mx,
                frac_active=float((a > 0).mean()),
                relative_norm=float(rel[fi]),
                cosine_sim=float(cos[fi]),
                acts_sample=nz[:10_000],
                top_seqs=seqs,
                interval_groups=groups,
                logit_lens=lens_tables[fi],
            ))
        return cls(vis_cfg, out)

    # -- rendering ----------------------------------------------------------
    def save_feature_centric_vis(
        self, path: str | Path, decode_fn: Callable[[int], str] | None = None,
        tokenizer: str | Path | None = None,
    ) -> Path:
        """Write one self-contained HTML file (nb:cell 42 equivalent).

        ``tokenizer`` — path to a local HF ``tokenizer.json`` (or a dir
        holding one): token ids then render as real text, as in the
        reference's sae_vis pages (nb:cells 36-42). Without either it and
        ``decode_fn``, ids render as ``⟨id⟩`` placeholders.
        """
        if decode_fn is None and tokenizer is not None:
            from crosscoder_tpu_torch.analysis.plots import decode_fn_from_file

            decode_fn = decode_fn_from_file(tokenizer)
        render = default_token_renderer(decode_fn)

        def seq_row(seq: dict, vmax: float) -> str:
            strs = [render(t) for t in seq["tokens"]]
            return (
                f'<div class="seq">'
                f'{tokens_to_html(strs, seq["values"], vmax=vmax, token_ids=seq["tokens"])}'
                f' <span class="peak">max {max(seq["values"]):.2f}</span></div>'
            )

        cards = []
        for fd in self.features:
            rows = [seq_row(seq, fd.max_act) for seq in fd.top_seqs]
            group_html = ""
            if fd.interval_groups:
                blocks = []
                for grp in fd.interval_groups:
                    grows = "".join(seq_row(s, fd.max_act) for s in grp["seqs"])
                    blocks.append(
                        f'<div class="group"><h3>{_html.escape(grp["label"])}'
                        f' <span class="peak">{len(grp["seqs"])} seqs</span></h3>'
                        f"{grows}</div>"
                    )
                group_html = f'<div class="groups">{"".join(blocks)}</div>'
            hist = (
                svg_histogram(fd.acts_sample) if fd.acts_sample.size else "<i>never active</i>"
            )
            lens_html = ""
            if fd.logit_lens:
                from crosscoder_tpu_torch.utils.logging import source_tag

                blocks = []
                for tab in fd.logit_lens:
                    # escape: a real tokenizer's decode can emit '<', '&', …
                    pos = " ".join(
                        f'<span class="tok plus">{_html.escape(render(t))}'
                        f'<sub>{v:+.2f}</sub></span>'
                        for t, v in tab["promoted"]
                    )
                    neg = " ".join(
                        f'<span class="tok minus">{_html.escape(render(t))}'
                        f'<sub>{v:+.2f}</sub></span>'
                        for t, v in tab["suppressed"]
                    )
                    blocks.append(
                        f'<div class="lens"><b>{source_tag(tab["source"])}</b>'
                        f'<div>promoted: {pos}</div>'
                        f'<div>suppressed: {neg}</div></div>'
                    )
                lens_html = f'<div class="lenses">{"".join(blocks)}</div>'
            cards.append(f"""
<div class="card">
  <h2>feature {fd.feature}</h2>
  <table class="stats">
    <tr><td>max act</td><td>{fd.max_act:.3f}</td>
        <td>active frac</td><td>{fd.frac_active:.4%}</td></tr>
    <tr><td>relative dec norm</td><td>{fd.relative_norm:.3f}</td>
        <td>dec cosine</td><td>{fd.cosine_sim:.3f}</td></tr>
  </table>
  <div class="hist">{hist}</div>
  {lens_html}
  <div class="seqs"><h3>top activations</h3>
  {"".join(rows) or "<i>no activating sequences in sample</i>"}</div>
  {group_html}
</div>""")
        doc = f"""<!doctype html><html><head><meta charset="utf-8">
<title>crosscoder feature dashboards</title>
<style>
 body {{ font-family: system-ui, sans-serif; margin: 1.5em; background: #fafafa; }}
 .card {{ background: #fff; border: 1px solid #ddd; border-radius: 8px;
          padding: 1em 1.2em; margin-bottom: 1.2em; max-width: 900px; }}
 .seq {{ font-family: ui-monospace, monospace; font-size: 13px; margin: .35em 0;
         white-space: nowrap; overflow-x: auto; }}
 .peak {{ color: #888; font-size: 11px; }}
 .lens {{ font-size: 12px; margin: .3em 0; }}
 .lens .tok {{ font-family: ui-monospace, monospace; padding: 0 2px; }}
 .lens .plus {{ background: #e2f2e4; }}
 .lens .minus {{ background: #f6e1e1; }}
 .lens sub {{ color: #777; font-size: 9px; }}
 .stats td {{ padding: 0 1em 0 0; color: #444; font-size: 13px; }}
 h2 {{ margin: .2em 0 .5em; font-size: 16px; }}
 h3 {{ margin: .6em 0 .2em; font-size: 13px; color: #555;
       text-transform: uppercase; letter-spacing: .04em; }}
 .group {{ border-top: 1px dashed #e5e5e5; }}
</style></head><body>
<h1>crosscoder feature dashboards</h1>
<p>{_html.escape(self.cfg.hook_point)} · {len(self.features)} features</p>
{"".join(cards)}
</body></html>"""
        path = Path(path)
        path.write_text(doc)
        return path
