"""The autotuner, ported from :mod:`crosscoder_tpu.tune`: a two-stage
search over the knobs every deployment used to pin by hand (refill
watermarks and dispatch batching, the prefetch, the quantized store, serve
batch ladders, fleet bucket caps).

- **Stage 1 (nothing runs):** :mod:`~crosscoder_tpu_torch.tune.lattice`
  enumerates the valid knob lattice from the config's own validation (a
  candidate IS a constructed ``CrossCoderConfig``) and prices each point on
  the port's shape cost model: the step's operations and leaf bytes at the
  H100's published peaks, the counted DP wire bytes over NVLink, and the
  JAX package's refill and harvest model with the card's measured harvest
  and dispatch times.
- **Stage 2 (measured):** :mod:`~crosscoder_tpu_torch.tune.calibrate` runs
  the top K as short windows through the real Trainer on the card, scored
  with the telemetry's span EMA and refill bubble (or the synchronized
  wall clock where the span times only the launches), each candidate first
  passing the step-identity gate: its step must be bitwise its projection
  onto the step fields' (``tune/rejected_contract`` counts a failure).

The winner is pinned as a ``TUNED.json``
(:mod:`~crosscoder_tpu_torch.tune.artifact`, the JAX package's document)
that ``--tuned <path>`` loads back through the config's resolution; the
elastic controller and the fleet policy read its per-topology siblings on
a re-mesh. Entry points run on ``cuda`` unless the caller names a device.
"""

from crosscoder_tpu_torch.tune.artifact import (TunedArtifact, apply_tuned, cached_artifact,
                                                config_hash, load_tuned, on_remesh,
                                                topology_key)
from crosscoder_tpu_torch.tune.autotune import tune
from crosscoder_tpu_torch.tune.calibrate import measure_window, step_identity_gate
from crosscoder_tpu_torch.tune.lattice import (Candidate, default_axes, enumerate_lattice,
                                               price_candidate, rank_candidates)

__all__ = [
    "TunedArtifact",
    "apply_tuned",
    "cached_artifact",
    "config_hash",
    "load_tuned",
    "on_remesh",
    "topology_key",
    "tune",
    "measure_window",
    "step_identity_gate",
    "Candidate",
    "default_axes",
    "enumerate_lattice",
    "price_candidate",
    "rank_candidates",
]
