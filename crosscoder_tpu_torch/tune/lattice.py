"""Stage 1 of the tuner: enumerate the valid knob lattice and price it
without running anything; ported from :mod:`crosscoder_tpu.tune.lattice`.

Candidates are real ``CrossCoderConfig`` objects: the lattice is the
cartesian product of the knob axes filtered by the config's OWN
validation (a point whose ``__post_init__`` raises is pruned; no copy of
the rules lives here). Pricing is arithmetic on the config:

- **device terms**: the port's shape cost model of one rank's step (the
  JAX package prices XLA's compiled cost of the step's HLO, which PyTorch
  does not have). Operations are :meth:`FleetPolicy.step_flops
  <crosscoder_tpu_torch.resilience.fleet.FleetPolicy.step_flops>` (the
  step's five dense products at the rank's shard shapes); bytes are the
  step's leaves read and written once, as O1's bound counts them (each
  value's parameter, gradient and both moments read, the parameter and
  both moments written, in the leaf's dtype). Knobs outside
  :data:`STEP_FIELDS` cannot change either: the stage-2 gate checks that
  assumption for every candidate it ships;
- **DP-sync term**: :func:`comm_model.wire_bytes
  <crosscoder_tpu_torch.parallel.comm_model.wire_bytes>` over the counted
  data-parallel profile of the step (:meth:`FleetPolicy.step_profile`) at
  the candidate's data width;
- **data-plane terms**: the JAX package's refill and harvest cost model
  (:func:`_data_plane_ms`) for ``refill_frac``, ``refill_overlap``,
  ``refill_dispatch_batch``, ``prefetch`` and ``quant_buffer``.

Only the RANKING matters (stage 2 measures the survivors). The constants
below are the card's and sit in one place, so the JAX package's can be set
in their stead to hold the arithmetic against its.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import sys
from typing import Any

from crosscoder_tpu_torch.parallel import comm_model
from crosscoder_tpu_torch.resilience import fleet

# The H100 SXM's published dense bf16 tensor-core peak (the score policy's
# and the kernels' figure, resilience/fleet.py) and its published HBM3 rate
# (chip_smoke.py's bounds): a part's data-sheet rates, not measurements.
PEAK_FLOPS = fleet.PEAK_FLOPS
HBM_GBPS = 3350.0
# the DP sum's link: comm_model's NVLink figure, as the score policy prices it
WIRE_GBPS = comm_model.NVLINK_GBPS
# One harvest quantum's host time (a SegmentedHarvest.step() of 3 Gemma-2-2B
# blocks over a [4, 1024] chunk in bf16, the card idle before it): the
# median of chip_smoke.py phase 19's 10 quanta, 6.172-10.115 ms, on an
# NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md §6, the tuner's first card run).
HOST_DISPATCH_MS = 8.476
# One reference batch's harvest on the card: a padded [4, 1024] chunk (4096
# token rows, _REF_BATCH) through both Gemma-2-2B models to block 14, ~120 ms
# (chip_smoke.py phase 9, PERF.md §5; an NVIDIA H100 80GB HBM3 at 700.00 W;
# a paged chunk ~83 ms).
HARVEST_REF_MS = 120.0
_REF_BATCH = 4096
# the JAX package's data-plane model shape: harvest quanta dispatched a
# serve, and the share of the batched dispatcher's host cost that still
# contends with the serve when it runs on its own thread
_QUANTA_PER_SERVE = 4
_OFF_CRITICAL = 0.1

# Config fields that change the step. Everything else is host or data
# plane and leaves the step as it is; the stage-2 gate checks a candidate
# against its projection onto this set.
STEP_FIELDS = frozenset({
    "activation", "topk_k", "sparse_decode", "factored_decode",
    "sparse_bwd", "fused_encoder", "quant_encoder", "quant_grads",
    "quant_block", "batch_size", "dict_size", "d_in", "n_models",
    "hook_points", "enc_dtype", "master_dtype", "l1_coeff", "l0_coeff",
    "aux_k", "aux_every", "remat", "grad_clip", "shard_sources",
    "data_axis_size", "model_axis_size", "seed",
})

OBJECTIVES = ("train", "serve", "fleet")


@dataclasses.dataclass
class Candidate:
    """One lattice point: the knob assignment and its validated config.

    ``base_sig`` identifies the base config the lattice was swept from
    (everything not on a knob axis)."""

    knobs: dict[str, Any]
    cfg: Any
    base_sig: str = ""
    predicted: dict[str, Any] = dataclasses.field(default_factory=dict)
    score: float | None = None

    @property
    def label(self) -> str:
        return ",".join(f"{k}={self.knobs[k]}" for k in sorted(self.knobs))


def default_axes(cfg: Any, objective: str = "train") -> dict[str, tuple]:
    """The stock knob axes of each objective (the JAX package's). Values
    the base config cannot validate are pruned at enumeration."""
    if objective == "train":
        return {
            "refill_overlap": ("off", "on"),
            "refill_dispatch_batch": (4, 8),
            "refill_frac": (0.25, 0.5),
            "prefetch": (False, True),
            "quant_buffer": (False, True),
        }
    if objective == "serve":
        return {
            "serve_max_batch": (8, 16, 32),
            "serve_max_wait_ms": (1.0, 2.0, 5.0),
            "page_size": tuple(p for p in (16, 32, 64)
                               if p <= cfg.seq_len and cfg.seq_len % p == 0) or (cfg.page_size,),
        }
    if objective == "fleet":
        return {
            "fleet_max_buckets": (2, 4, 8),
            "refill_frac": (0.25, 0.5),
            "prefetch": (False, True),
        }
    raise ValueError(f"objective must be one of {OBJECTIVES}, got {objective!r}")


def enumerate_lattice(base_cfg: Any, axes: dict[str, tuple]) -> tuple[list[Candidate], int]:
    """The cartesian product of ``axes`` over ``base_cfg``, keeping exactly
    the points the config's validation accepts: ``(candidates,
    n_pruned_invalid)``. Axes iterate in sorted-name order, values in the
    order given."""
    names = sorted(axes)
    base_dict = {k: v for k, v in base_cfg.to_dict().items() if k not in axes}
    base_sig = hashlib.sha256(
        json.dumps(base_dict, sort_keys=True, default=str).encode()).hexdigest()[:16]
    out: list[Candidate] = []
    pruned = 0
    for values in itertools.product(*(axes[n] for n in names)):
        knobs = dict(zip(names, values))
        try:
            cfg = base_cfg.replace(**knobs)
        except (ValueError, TypeError):
            pruned += 1
            continue
        out.append(Candidate(knobs=knobs, cfg=cfg, base_sig=base_sig))
    return out, pruned


# ---------------------------------------------------------------------------
# static pricing


def _step_signature(cand: Candidate) -> str:
    """The base config's identity and the candidate's step knobs: two
    candidates that differ only in data-plane knobs share it."""
    step_knobs = {k: v for k, v in sorted(cand.knobs.items()) if k in STEP_FIELDS}
    return cand.base_sig + "|" + json.dumps(step_knobs, sort_keys=True, default=str)


def _step_cost(cand: Candidate, n_devices: int) -> dict[str, float]:
    """One rank's step at the candidate's grid (``n_devices`` split by
    ``model_axis_size``): its operations, the bytes of its leaves read and
    written once, and its modeled DP wire bytes."""
    cfg = cand.cfg
    pol = fleet.FleetPolicy(cfg)
    n_model = max(1, int(cfg.model_axis_size))
    n_data = max(1, n_devices // n_model)
    theta = cfg.dict_size // n_model if cfg.activation == "jumprelu" else 0
    master = 4 if cfg.master_dtype == "fp32" else 2
    leaf_bytes = (pol.rank_params(n_model) - theta) * master + theta * 4     # log_theta: f32
    return {
        "flops": pol.step_flops(n_data, n_model),
        "bytes_accessed": 7.0 * leaf_bytes,     # p, g, m, v read; p, m, v written
        "wire_bytes": comm_model.wire_bytes(pol.step_profile(n_data, n_model), axis_size=n_data),
    }


def _data_plane_ms(cfg: Any, device_ms: float) -> dict[str, float]:
    """The JAX package's refill cost model, per step:

    - harvest: a harvested row is served ``0.5/refill_frac`` times (the
      trigger fires at half the buffer), so a serve's share of the harvest
      scales as ``2·refill_frac``;
    - host dispatch: without the overlap every quantum's host time lands on
      the serve; the overlap batches ``refill_dispatch_batch`` quanta a
      dispatch off the serve's thread, leaving some contention and the
      device time the step cannot hide;
    - the serve's gather: hidden by ``prefetch``; ``quant_buffer`` reads
      about 0.51× the store's bytes.
    """
    batch_scale = cfg.batch_size / _REF_BATCH
    harvest_dev_ms = HARVEST_REF_MS * batch_scale * (2.0 * cfg.refill_frac)
    q = _QUANTA_PER_SERVE
    gather_bytes = cfg.batch_size * cfg.n_sources * cfg.d_in * (1.04 if cfg.quant_buffer else 2.0)
    gather_ms = 1e3 * gather_bytes / (HBM_GBPS * 1e9)
    if cfg.refill_overlap == "on":
        k = max(1, int(cfg.refill_dispatch_batch))
        host_ms = q * HOST_DISPATCH_MS / k * _OFF_CRITICAL
        bubble_ms = max(0.0, harvest_dev_ms - device_ms)
    else:
        host_ms = q * HOST_DISPATCH_MS
        bubble_ms = harvest_dev_ms
    fetch_ms = 0.0 if cfg.prefetch else gather_ms
    return {
        "harvest_ms": harvest_dev_ms,
        "refill_host_ms": host_ms,
        "refill_bubble_ms": bubble_ms,
        "fetch_ms": fetch_ms,
    }


def price_candidate(cand: Candidate, objective: str = "train",
                    n_devices: int = 1) -> dict[str, Any]:
    """The stage-1 price of one candidate for ``objective``: fills
    ``cand.predicted`` and ``cand.score`` and returns the breakdown. A
    higher score is better for every objective (latency objectives score
    the negated prediction)."""
    cfg = cand.cfg
    step = _step_cost(cand, n_devices)
    compute_ms = 1e3 * step["flops"] / PEAK_FLOPS
    hbm_ms = 1e3 * step["bytes_accessed"] / (HBM_GBPS * 1e9)
    device_ms = max(compute_ms, hbm_ms)
    wire_ms = 1e3 * step["wire_bytes"] / (WIRE_GBPS * 1e9)
    plane = _data_plane_ms(cfg, device_ms)
    total_ms = (device_ms + wire_ms + plane["refill_host_ms"] + plane["refill_bubble_ms"]
                + plane["fetch_ms"])
    pred: dict[str, Any] = {
        "device_ms": device_ms, "wire_ms": wire_ms, "step_total_ms": total_ms, **step, **plane,
    }
    if objective == "train":
        score = cfg.batch_size * 1e3 / (total_ms * max(1, n_devices))
        pred["acts_per_sec_chip"] = score
    elif objective == "serve":
        b = int(cfg.serve_max_batch)
        nd = cfg.n_sources * cfg.d_in
        encode_ms = 1e3 * (2.0 * b * nd * cfg.dict_size) / PEAK_FLOPS
        # a request pads its tail to a whole KV page
        page_waste = cfg.page_size / (2.0 * cfg.seq_len)
        prefill_ms = HARVEST_REF_MS * (b / _REF_BATCH) * (1.0 + page_waste)
        p99_ms = cfg.serve_max_wait_ms + prefill_ms + encode_ms
        pred.update(encode_ms=encode_ms, prefill_ms=prefill_ms, p99_ms=p99_ms)
        score = -p99_ms
    elif objective == "fleet":
        n_tenants = max(1, len([t for t in cfg.fleet_tenants.split(";") if t.strip()]) or 1)
        buckets = min(n_tenants, max(1, int(cfg.fleet_max_buckets)))
        round_ms = (plane["harvest_ms"] + plane["refill_host_ms"]
                    + buckets * (device_ms + wire_ms))
        score = n_tenants * cfg.batch_size * 1e3 / (round_ms * max(1, n_devices))
        pred.update(round_ms=round_ms, n_buckets=buckets, agg_acts_per_sec_chip=score)
    else:
        raise ValueError(f"objective must be one of {OBJECTIVES}, got {objective!r}")
    pred["score"] = score
    cand.predicted = pred
    cand.score = score
    return pred


def rank_candidates(candidates: list[Candidate], objective: str = "train",
                    n_devices: int = 1, seed: int = 0) -> list[Candidate]:
    """Price every candidate and return them best first. Exact ties break
    on a seeded hash of the knob assignment (the same in every process). A
    candidate whose pricing fails is dropped with a note on stderr: pricing
    runs over arbitrary axes."""
    priced: list[Candidate] = []
    for cand in candidates:
        try:
            price_candidate(cand, objective, n_devices)
            priced.append(cand)
        except Exception as e:  # noqa: BLE001 — a user's lattice; noted and dropped
            print(f"[crosscoder_tpu_torch] tune: pricing {cand.label} failed "
                  f"({type(e).__name__}: {e})"[:300], file=sys.stderr, flush=True)

    def tie(c: Candidate) -> str:
        return hashlib.sha256(
            f"{seed}:{json.dumps(c.knobs, sort_keys=True, default=str)}".encode()).hexdigest()

    priced.sort(key=lambda c: (-c.score, tie(c)))
    return priced
