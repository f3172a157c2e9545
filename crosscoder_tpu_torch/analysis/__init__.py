"""Analysis layer, ported from :mod:`crosscoder_tpu.analysis`: decoder-space
diffing and the CE-recovered splicing eval."""

from crosscoder_tpu_torch.analysis.decoder import (  # noqa: F401
    cosine_sims,
    decoder_norms,
    relative_norm_histogram,
    relative_norms,
    shared_latent_mask,
)
from crosscoder_tpu_torch.analysis.ce_eval import get_ce_recovered_metrics  # noqa: F401
