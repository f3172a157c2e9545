"""Plot helpers, ported from :mod:`crosscoder_tpu.analysis.plots`
(reference ``utils.py:45-147``), rendering optional.

- ``imshow``/``line``/``scatter``/``bar``/``histogram`` return plotly
  figures when plotly is importable and raise :class:`ImportError`
  otherwise (the data-returning analysis functions and the HTML
  renderers need nothing);
- the token heatmap (the reference's ``create_html``) renders to a
  self-contained HTML string with no dependency; it is the building block
  of the latent dashboards.
"""

from __future__ import annotations

import html as _html
from typing import Any, Callable, Sequence

import numpy as np


def _plotly():
    try:
        import plotly.express as px  # type: ignore

        return px
    except Exception as e:  # plotly not installed
        raise ImportError(
            "plotly is not available; use the data-returning analysis "
            "functions or the HTML renderers instead"
        ) from e


def _host(a: Any) -> np.ndarray:
    """A tensor (on any device) or array-like as host numpy."""
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def imshow(array: Any, **kwargs: Any):
    """Heatmap (reference ``utils.py:48-53``: px.imshow with RdBu/zero-center)."""
    px = _plotly()
    kwargs.setdefault("color_continuous_scale", "RdBu")
    kwargs.setdefault("color_continuous_midpoint", 0.0)
    return px.imshow(_host(array), **kwargs)


def line(y: Any, **kwargs: Any):
    px = _plotly()
    return px.line(y=_host(y), **kwargs)


def scatter(x: Any, y: Any, **kwargs: Any):
    px = _plotly()
    return px.scatter(x=_host(x), y=_host(y), **kwargs)


def bar(y: Any, **kwargs: Any):
    px = _plotly()
    return px.bar(y=_host(y), **kwargs)


def histogram(x: Any, **kwargs: Any):
    """px.histogram wrapper — the reference's relative-norm and cosine-sim
    figures (``analysis.py:16-32,48-58``; the latter uses log_y=True)."""
    px = _plotly()
    return px.histogram(x=_host(x), **kwargs)


# ---------------------------------------------------------------------------
# dependency-free HTML rendering


def _act_color(v: float, vmax: float) -> str:
    """White → orange background by activation magnitude (sae_vis style)."""
    if vmax <= 0:
        return "#ffffff"
    t = max(0.0, min(1.0, v / vmax))
    r, g, b = 255, int(237 - t * 90), int(217 - t * 190)
    return f"rgb({r},{g},{b})"


def tokens_to_html(
    token_strs: Sequence[str],
    values: Sequence[float],
    vmax: float | None = None,
    token_ids: Sequence[int] | None = None,
) -> str:
    """One sequence as an inline token heatmap — the reference's
    ``create_html`` (``utils.py:96-147``): token background encodes the
    per-token value, hover shows the detail; newlines become visible '↵'.

    ``token_ids`` enriches each token's hover tooltip with its id (the
    sae_vis fork's per-token hover detail, nb:cells 36-42) — useful when a
    rendered string is ambiguous (whitespace variants, byte fallbacks)."""
    vals = np.asarray(values, dtype=np.float32)
    vmax = float(vals.max()) if vmax is None else vmax
    spans = []
    ids = [None] * len(vals) if token_ids is None else token_ids
    for tok, v, tid in zip(token_strs, vals, ids):
        shown = tok.replace("\n", "↵")
        title = f"{float(v):.3f}"
        if tid is not None:
            title = f"{_html.escape(shown)} · id {int(tid)} · act {title}"
        spans.append(
            f'<span title="{title}" style="background:{_act_color(float(v), vmax)};'
            f'border-radius:2px;padding:0 1px">{_html.escape(shown)}</span>'
        )
    return "".join(spans)


def svg_histogram(
    values: Sequence[float], bins: int = 40, width: int = 360, height: int = 80,
    color: str = "#e8833a",
) -> str:
    """Tiny dependency-free SVG bar histogram (dashboard activation
    distributions)."""
    vals = np.asarray(values, dtype=np.float32)
    counts, edges = np.histogram(vals, bins=bins)
    peak = max(int(counts.max()), 1)
    bw = width / bins
    bars = []
    for i, c in enumerate(counts):
        h = height * int(c) / peak
        bars.append(
            f'<rect x="{i * bw:.1f}" y="{height - h:.1f}" width="{bw - 1:.1f}" '
            f'height="{h:.1f}" fill="{color}"><title>'
            f"[{edges[i]:.3g}, {edges[i + 1]:.3g}): {int(c)}</title></rect>"
        )
    return (
        f'<svg width="{width}" height="{height}" '
        f'xmlns="http://www.w3.org/2000/svg">{"".join(bars)}</svg>'
    )


def default_token_renderer(decode_fn: Callable[[int], str] | None):
    """Token-id → display string; without a tokenizer, ids render as ⟨id⟩."""
    if decode_fn is None:
        return lambda tid: f"⟨{int(tid)}⟩"
    return lambda tid: decode_fn(int(tid))


def decode_fn_from_file(path) -> Callable[[int], str]:
    """Token-id → text from a LOCAL HF tokenizer file — no network.

    ``path`` is a ``tokenizer.json`` (HF tokenizers format, the artifact
    shipped inside every Gemma checkpoint dir) or a directory containing
    one. Dashboards/replication render real text when this is wired in
    (reference dashboards always had the tokenizer via TransformerLens,
    nb:cells 36-42) and fall back to ⟨id⟩ placeholders otherwise.
    """
    import os
    from pathlib import Path

    # single-token decodes gain nothing from the Rust worker pool
    os.environ.setdefault("TOKENIZERS_PARALLELISM", "false")
    from tokenizers import Tokenizer

    p = Path(path)
    if p.is_dir():
        p = p / "tokenizer.json"
    tok = Tokenizer.from_file(str(p))

    import functools

    @functools.lru_cache(maxsize=65536)
    def decode(tid: int) -> str:
        # cached: dashboards render the same small set of distinct ids many
        # times, and each decode is an FFI round trip into the Rust lib
        text = tok.decode([int(tid)], skip_special_tokens=False)
        if text:
            return text
        piece = tok.id_to_token(int(tid))
        return piece if piece is not None else f"⟨{int(tid)}⟩"

    return decode
