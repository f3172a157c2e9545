"""Typed configuration, ported from :mod:`crosscoder_tpu.config`.

:class:`CrossCoderConfig` keeps every field name and default of the JAX
dataclass, so a cfg JSON written by either package loads in the other.
Validation is ported for the fields the port reads: the serving knobs
(``enc_dtype``, ``activation``, ``page_size``, ``seq_len``, ``serve_*``)
and the training knobs (``crosscoder_tpu/config.py`` ``__post_init__``:
the TopK tier rules for ``sparse_decode``/``factored_decode``/
``sparse_bwd``/``fused_encoder``/``quant_encoder``, the sparsity and AuxK
knobs, the loop, guard, watchdog and telemetry knobs (``obs``,
``profile_steps``), ``quant_grads`` only under pure data
parallelism and not with ``batchtopk``, ``n_sources`` divisible by the
model axis under ``shard_sources``) and the replay-buffer knobs
(``refill_frac``, ``buffer_device``, ``seq_shards``, ``shard_lm``,
``refill_overlap``, ``quant_block`` under ``quant_buffer``), with the JAX
package's messages, and the fleet knobs (``fleet_max_buckets >= 1``, no
``quant_grads`` under ``fleet="on"``, no ``fleet_tenants`` without it).
:meth:`CrossCoderConfig.check_buffer` refuses a buffer too small to
build. Knobs of parts not ported yet (the compile cache) are carried as
plain values. :meth:`CrossCoderConfig.from_cli` reflects every field into a
flag as the JAX package does, and applies a pinned ``TUNED.json``
(``--tuned``, :mod:`crosscoder_tpu_torch.tune`) between a config JSON and
the explicit flags.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

from crosscoder_tpu_torch.utils.dtypes import DTYPES

DTYPE_NAMES = tuple(DTYPES)

_ACTIVATIONS = ("relu", "topk", "jumprelu", "batchtopk")


def _check_choice(field_name: str, value: Any, choices: tuple[str, ...]) -> None:
    """Membership check for a string mode knob, with the JAX package's
    difflib hint for a near miss."""
    if value in choices:
        return
    import difflib

    close = difflib.get_close_matches(str(value), choices, n=1)
    hint = f"; did you mean {close[0]!r}?" if close else ""
    raise ValueError(f"{field_name} must be {'|'.join(choices)}, got {value!r}{hint}")


@dataclass
class CrossCoderConfig:
    """Full training/analysis/serving configuration (field names and
    defaults identical to the JAX package's)."""

    # --- reference keys (reference train.py:13-35) ---
    seed: int = 49
    batch_size: int = 4096
    buffer_mult: int = 128
    lr: float = 5e-5
    num_tokens: int = 400_000_000
    l1_coeff: float = 2.0
    beta1: float = 0.9
    beta2: float = 0.999
    dict_size: int = 2 ** 14
    seq_len: int = 1024
    enc_dtype: str = "bf16"
    model_name: str = "gemma-2-2b"
    site: str = "resid_pre"
    device: str = "tpu"             # kept for cfg-JSON compat; the port's
                                    # entry points take an explicit device
    model_batch_size: int = 4
    log_every: int = 100
    save_every: int = 30000
    dec_init_norm: float = 0.08
    hook_point: str = "blocks.14.hook_resid_pre"
    wandb_project: str = ""
    wandb_entity: str = ""
    d_in: int = 2304

    # --- extensions of the JAX package ---
    n_models: int = 2
    hook_points: tuple[str, ...] = ()
    activation: str = "relu"
    topk_k: int = 32
    sparse_decode: bool = False
    factored_decode: str = "auto"
    sparse_bwd: str = "auto"
    fused_encoder: str = "auto"
    quant_encoder: bool = False
    jumprelu_theta: float = 0.001
    jumprelu_bandwidth: float = 0.001
    l0_coeff: float = 0.0
    aux_k: int = 0
    aux_k_coeff: float = 1.0 / 32.0
    aux_dead_steps: int = 500
    aux_exact_rank: bool = False
    aux_every: int = 1
    resample_every: int = 0
    resample_dead_steps: int = 0
    resample_enc_scale: float = 0.2
    batchtopk_threshold: float = 0.0
    data_axis_size: int = -1
    model_axis_size: int = 1
    shard_sources: bool = False
    buffer_device: str = "host"
    shard_lm: bool = False
    seq_shards: int = 0
    harvest_runtime: str = "padded"
    page_size: int = 64             # paged runtime: tokens per KV page
    grad_clip: float = 1.0
    lr_decay_frac: float = 0.2
    l1_warmup_frac: float = 0.05
    norm_calib_batches: int = 100
    refill_frac: float = 0.5
    checkpoint_dir: str = "./checkpoints"
    data_dir: str = "./data"
    dataset_name: str = "ckkissane/pile-lmsys-mix-1m-tokenized-gemma-2"
    log_backend: str = "auto"
    profile_dir: str = ""
    remat: bool = False
    data_source: str = "gemma"
    model_names: tuple[str, ...] = ()
    resume: bool = False
    prefetch: bool = True
    refill_overlap: str = "off"
    refill_dispatch_batch: int = 4
    stop_poll_every: int = 20
    guard_loss: bool = False
    loss_spike_factor: float = 10.0
    max_rollbacks: int = 3
    keep_saves: int = 0
    harvest_timeout_s: float = 0.0
    harvest_retries: int = 3
    harvest_backoff_s: float = 0.5
    elastic: str = "off"
    elastic_heartbeat_s: float = 1.0
    elastic_grace_s: float = 5.0
    elastic_suspect_probes: int = 2
    elastic_grow: str = "off"
    elastic_dwell_steps: int = 2
    elastic_grow_debounce: int = 2
    elastic_policy: str = "fixed"
    fleet: str = "off"
    fleet_tenants: str = ""
    fleet_max_buckets: int = 8
    # --- online serving (serve/engine.py) ---
    serve: str = "off"              # off | on: the online model-diffing
                                    # request path
    serve_max_batch: int = 8        # micro-batch cap: the largest batch
                                    # bucket; a power of two <= 128
    serve_max_wait_ms: float = 5.0  # deadline of the oldest admitted
                                    # request before a partial plane flushes
    serve_queue: int = 64           # bounded admission queue; submits
                                    # beyond it shed
    serve_shed_ms: float = 0.0      # > 0: queued requests older than this
                                    # are evicted
    quant_buffer: bool = False
    quant_grads: bool = False
    quant_block: int = 256
    obs: str = "off"
    obs_dir: str = ""
    profile_steps: str = ""
    log_print_every: int = 1
    aux_mask_every: int = 1
    chaos: str = ""
    tuned: str = ""
    compile_cache_dir: str = ""
    compile_cache_max_bytes: int = 1 << 30
    compile_cache_verify: str = "off"
    master_dtype: str = "fp32"

    # unknown keys from foreign cfg JSONs, preserved on round-trip
    extras: dict[str, Any] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.enc_dtype not in DTYPE_NAMES:
            raise ValueError(f"enc_dtype must be one of {DTYPE_NAMES}, got {self.enc_dtype!r}")
        if self.activation not in _ACTIVATIONS:
            raise ValueError(f"activation must be one of {_ACTIVATIONS}, got {self.activation!r}")
        if self.n_models < 1:
            raise ValueError("n_models must be >= 1")
        if isinstance(self.hook_points, list):
            self.hook_points = tuple(self.hook_points)
        if isinstance(self.model_names, list):
            self.model_names = tuple(self.model_names)
        if self.data_source not in ("gemma", "synthetic"):
            raise ValueError(f"data_source must be 'gemma' or 'synthetic', got {self.data_source!r}")
        if self.master_dtype not in ("fp32", "bf16"):
            raise ValueError(f"master_dtype must be fp32 or bf16, got {self.master_dtype!r}")
        if self.topk_k < 1:
            raise ValueError(f"topk_k must be >= 1, got {self.topk_k}")
        if self.seq_len < 1:
            raise ValueError(f"seq_len must be >= 1, got {self.seq_len}")
        _check_choice("harvest_runtime", self.harvest_runtime, ("padded", "paged"))
        if self.page_size < 1 or self.page_size & (self.page_size - 1):
            raise ValueError(
                f"page_size must be a power of two (the KV page is the "
                f"attention kernel's page quantum), got {self.page_size}"
            )
        if self.harvest_runtime == "paged" and self.seq_len < self.page_size:
            raise ValueError(
                f"harvest_runtime='paged': seq_len {self.seq_len} is smaller "
                f"than page_size {self.page_size}"
            )
        if self.harvest_runtime == "paged" and self.seq_len % self.page_size:
            raise ValueError(
                f"harvest_runtime='paged': page_size {self.page_size} must "
                f"divide seq_len {self.seq_len}"
            )
        self._check_training_fields()
        self._check_buffer_fields()
        _check_choice("serve", self.serve, ("off", "on"))
        if self.serve == "on":
            b = self.serve_max_batch
            if not 1 <= b <= 128 or b & (b - 1):
                raise ValueError(
                    f"serve_max_batch must be a power of two in [1, 128], got {b}"
                )
            if self.serve_max_wait_ms < 0:
                raise ValueError(
                    f"serve_max_wait_ms must be >= 0, got {self.serve_max_wait_ms}"
                )
            if self.serve_queue < self.serve_max_batch:
                raise ValueError(
                    f"serve_queue ({self.serve_queue}) must be >= "
                    f"serve_max_batch ({self.serve_max_batch}): the queue "
                    f"must be able to hold at least one full micro-batch"
                )
            if self.serve_shed_ms < 0:
                raise ValueError(
                    f"serve_shed_ms must be >= 0 (0 disables queue-age "
                    f"eviction), got {self.serve_shed_ms}"
                )

    def _check_training_fields(self) -> None:
        """The JAX package's training-field rules
        (``crosscoder_tpu/config.py:669-776`` and the loop knobs after)."""
        if self.sparse_decode and self.activation != "topk":
            raise ValueError(
                f"sparse_decode requires activation='topk', got {self.activation!r}")
        _check_choice("factored_decode", self.factored_decode, ("auto", "on", "off"))
        if self.factored_decode == "on" and self.activation != "topk":
            raise ValueError(
                f"factored_decode='on' requires activation='topk', got {self.activation!r}")
        if self.factored_decode == "on" and self.l1_coeff != 0:
            raise ValueError(
                "factored_decode='on' requires l1_coeff=0: the factored forward's "
                "custom backward carries no gradient path through (vals, idx), "
                "which a nonzero weighted-L1 objective needs")
        _check_choice("sparse_bwd", self.sparse_bwd, ("auto", "on", "off"))
        if self.sparse_bwd == "on" and self.activation != "topk":
            raise ValueError(
                f"sparse_bwd='on' requires activation='topk' (the sparse backward "
                f"consumes the factored (vals, idx) the TopK tier produces), got "
                f"{self.activation!r}")
        if self.sparse_bwd == "on" and self.l1_coeff != 0:
            raise ValueError(
                "sparse_bwd='on' requires l1_coeff=0: like the factored tier it "
                "extends, its custom backward carries no gradient path through "
                "(vals, idx)")
        if self.sparse_bwd == "on" and self.sparse_decode:
            raise ValueError(
                "sparse_bwd='on' is incompatible with sparse_decode: the sparse "
                "backward extends the factored tier, not the gather decode")
        _check_choice("fused_encoder", self.fused_encoder, ("auto", "on", "off"))
        if self.fused_encoder == "on":
            if self.activation not in ("topk", "batchtopk"):
                raise ValueError(
                    f"fused_encoder='on' requires activation='topk' or 'batchtopk' "
                    f"(the kernel is a fused TopK/BatchTopK selection), got "
                    f"{self.activation!r}")
            if self.activation == "topk":
                if self.sparse_bwd == "off":
                    raise ValueError(
                        "fused_encoder='on' with activation='topk' requires "
                        "sparse_bwd != 'off': the fused forward hands (vals, idx) "
                        "to the sparse backward plane")
                if self.l1_coeff != 0:
                    raise ValueError(
                        "fused_encoder='on' with activation='topk' requires "
                        "l1_coeff=0 (the factored/sparse tier it rides carries no "
                        "gradient path through (vals, idx))")
                if self.sparse_decode:
                    raise ValueError(
                        "fused_encoder='on' is incompatible with sparse_decode: the "
                        "fused tier extends the factored tier, not the gather decode")
        if self.quant_encoder:
            if self.fused_encoder == "off":
                raise ValueError(
                    "quant_encoder requires fused_encoder != 'off': the int8 "
                    "block-scaled matmul lives inside the fused kernel")
            if self.activation != "topk":
                raise ValueError(
                    f"quant_encoder requires activation='topk': the int8 path lives "
                    f"in the fused TopK kernel only, got {self.activation!r}")
            nd = self.n_sources * self.d_in
            if self.quant_block % 128 or nd % self.quant_block:
                raise ValueError(
                    f"quant_encoder: quant_block {self.quant_block} must be a "
                    f"multiple of 128 dividing n_sources*d_in = {nd}")
        if self.l0_coeff > 0 and self.activation != "jumprelu":
            raise ValueError(
                f"l0_coeff requires activation='jumprelu' (the rectangle-kernel STE "
                f"needs a threshold), got {self.activation!r}")
        if self.batchtopk_threshold > 0 and self.activation != "batchtopk":
            raise ValueError(
                f"batchtopk_threshold requires activation='batchtopk', got "
                f"{self.activation!r}")
        if self.aux_k < 0:
            raise ValueError(f"aux_k must be >= 0, got {self.aux_k}")
        if self.aux_k > self.dict_size:
            raise ValueError(f"aux_k {self.aux_k} cannot exceed dict_size {self.dict_size}")
        if self.aux_k > 0 and self.aux_dead_steps < 1:
            raise ValueError("aux_dead_steps must be >= 1 when aux_k > 0")
        if self.aux_every < 1:
            raise ValueError(f"aux_every must be >= 1, got {self.aux_every}")
        if self.resample_every < 0 or self.resample_dead_steps < 0:
            raise ValueError(
                f"resample_every/resample_dead_steps must be >= 0, got "
                f"{self.resample_every}/{self.resample_dead_steps}")
        if self.resample_every > 0 and self.resample_threshold_steps < 1:
            raise ValueError(
                "resampling needs a deadness threshold: set resample_dead_steps "
                "(or aux_dead_steps) >= 1")
        if self.stop_poll_every < 1:
            raise ValueError(f"stop_poll_every must be >= 1, got {self.stop_poll_every}")
        if self.loss_spike_factor <= 1.0:
            raise ValueError(
                f"loss_spike_factor must be > 1 (it multiplies the last healthy "
                f"loss), got {self.loss_spike_factor}")
        if self.max_rollbacks < 0:
            raise ValueError(f"max_rollbacks must be >= 0, got {self.max_rollbacks}")
        if self.keep_saves < 0:
            raise ValueError(f"keep_saves must be >= 0 (0 = unbounded), got {self.keep_saves}")
        if self.guard_loss and self.keep_saves == 1:
            raise ValueError(
                "guard_loss with keep_saves=1 leaves rollback no fallback save "
                "when the newest is corrupt/poisoned; use keep_saves=0 "
                "(unbounded) or >= 2")
        if self.quant_block < 1:
            raise ValueError(f"quant_block must be >= 1, got {self.quant_block}")
        if (self.shard_sources and self.model_axis_size > 1
                and self.n_sources % self.model_axis_size != 0):
            raise ValueError(
                f"shard_sources: n_sources {self.n_sources} must divide by "
                f"model_axis_size {self.model_axis_size}")
        if self.quant_grads and (self.model_axis_size > 1 or self.shard_sources):
            raise ValueError(
                "quant_grads supports pure data parallelism only "
                "(model_axis_size == 1, shard_sources off): the quantized "
                "all-reduce replaces the DP gradient psum; TP/EP grad "
                "slices keep the exact bf16/f32 psum")
        if self.quant_grads and self.activation == "batchtopk":
            raise ValueError(
                "quant_grads is incompatible with activation='batchtopk': "
                "the quantized step computes per-device losses, but "
                "batchtopk's threshold is a GLOBAL-batch order statistic")
        if self.harvest_timeout_s < 0:
            raise ValueError(f"harvest_timeout_s must be >= 0, got {self.harvest_timeout_s}")
        if self.harvest_retries < 0 or self.harvest_backoff_s < 0:
            raise ValueError(
                f"harvest_retries/harvest_backoff_s must be >= 0, got "
                f"{self.harvest_retries}/{self.harvest_backoff_s}")
        self._check_elastic_fields()
        _check_choice("obs", self.obs, ("off", "on"))
        if self.log_print_every < 0:
            raise ValueError(
                f"log_print_every must be >= 0 (0 = never echo), got "
                f"{self.log_print_every}")
        if self.profile_steps:
            from crosscoder_tpu_torch.obs.profiler import parse_profile_steps

            parse_profile_steps(self.profile_steps)     # raises on a bad spec
        if self.aux_mask_every < 0:
            raise ValueError(
                f"aux_mask_every must be >= 0 (1 = per-step exact, N = refresh "
                f"every N steps, 0 = follow log_every), got {self.aux_mask_every}")
        _check_choice("fleet", self.fleet, ("off", "on"))
        if self.fleet == "on":
            if self.fleet_max_buckets < 1:
                raise ValueError(
                    f"fleet_max_buckets must be >= 1, got "
                    f"{self.fleet_max_buckets} (each stacked cohort and "
                    f"each heterogeneous tenant signature costs one "
                    f"compile bucket)")
            if self.quant_grads:
                raise ValueError(
                    "fleet='on' is incompatible with quant_grads: the "
                    "stacked (vmapped) tenant step cannot nest the "
                    "shard_map quantized all-reduce; train quantized "
                    "sweeps as sequential solo runs")
        elif self.fleet_tenants:
            raise ValueError(
                "fleet_tenants is set but fleet='off'; pass --fleet on "
                "(the spec would otherwise be silently ignored)")

    def _check_elastic_fields(self) -> None:
        """The JAX package's elastic-membership field rules, with its
        messages."""
        _check_choice("elastic", self.elastic, ("off", "on"))
        if self.elastic == "on":
            if self.elastic_heartbeat_s <= 0:
                raise ValueError(
                    f"elastic_heartbeat_s must be > 0, got "
                    f"{self.elastic_heartbeat_s}")
            if self.elastic_grace_s < self.elastic_heartbeat_s:
                raise ValueError(
                    f"elastic_grace_s ({self.elastic_grace_s}) must be >= "
                    f"elastic_heartbeat_s ({self.elastic_heartbeat_s}): the "
                    f"liveness barrier cannot declare a peer lost faster "
                    f"than the heartbeat can notice it")
            if self.seq_shards > 1:
                raise ValueError(
                    "elastic='on' cannot run with seq_shards > 1: the "
                    "sequence-parallel harvest pins the mesh data axis to "
                    "seq_shards, which a survivor re-mesh cannot preserve")
            if self.elastic_suspect_probes < 1:
                raise ValueError(
                    f"elastic_suspect_probes must be >= 1, got "
                    f"{self.elastic_suspect_probes} (1 = declare on the "
                    f"first failed probe, no hysteresis)")
        _check_choice("elastic_grow", self.elastic_grow, ("off", "on"))
        _check_choice("elastic_policy", self.elastic_policy, ("fixed", "score"))
        if self.elastic_grow == "on":
            if self.elastic != "on":
                raise ValueError(
                    "elastic_grow='on' requires elastic='on': scale-up "
                    "re-forms the world the elastic membership layer owns")
            if not self.checkpoint_dir:
                raise ValueError(
                    "elastic_grow='on' requires checkpoint_dir: the rejoin "
                    "rendezvous board and the admission boundary save both "
                    "live under it (joiners hydrate from that save)")
            if self.elastic_dwell_steps < 0:
                raise ValueError(
                    f"elastic_dwell_steps must be >= 0, got "
                    f"{self.elastic_dwell_steps}")
            if self.elastic_grow_debounce < 1:
                raise ValueError(
                    f"elastic_grow_debounce must be >= 1, got "
                    f"{self.elastic_grow_debounce}")

    def _check_buffer_fields(self) -> None:
        """The JAX package's replay-buffer and harvest field rules."""
        if not (0.0 < self.refill_frac <= 1.0):
            raise ValueError(
                f"refill_frac must be a buffer fraction in (0, 1], got "
                f"{self.refill_frac}; 0.5 is reference parity (1:1 "
                f"harvest:serve), smaller values re-serve survivors "
                f"~0.5/refill_frac times")
        if self.refill_frac > 0.5:
            raise ValueError(
                f"refill_frac must be <= 0.5 (the serve trigger fires at "
                f"half-buffer, so a larger refill would overwrite unserved "
                f"rows), got {self.refill_frac}; set 0.5 for reference parity")
        _check_choice("buffer_device", self.buffer_device, ("host", "hbm"))
        if self.seq_shards < 0:
            raise ValueError("seq_shards must be >= 0")
        if self.shard_lm and self.model_axis_size < 2:
            raise ValueError(
                "shard_lm needs model_axis_size >= 2 (a 1-wide model axis "
                "shards nothing)")
        if self.shard_lm and self.seq_shards > 1:
            raise ValueError(
                "shard_lm is incompatible with seq_shards: the seq-parallel "
                "harvest runs whole LM params on every rank, the memory "
                "shard_lm exists to save")
        if self.seq_shards > 1 and self.seq_len % self.seq_shards != 0:
            raise ValueError(f"seq_shards {self.seq_shards} must divide seq_len {self.seq_len}")
        if self.harvest_runtime == "paged" and self.seq_shards > 1:
            raise ValueError(
                "harvest_runtime='paged' is incompatible with "
                "seq_shards: the paged plane packs the sequence axis "
                "densely, while the seq-parallel harvest shards it "
                "over the mesh — pick one")
        _check_choice("refill_overlap", self.refill_overlap, ("off", "on"))
        if self.refill_dispatch_batch < 1:
            raise ValueError(
                f"refill_dispatch_batch must be >= 1 (harvest quanta fused "
                f"per dispatch), got {self.refill_dispatch_batch}")
        if self.quant_buffer and self.d_in % self.quant_block != 0:
            divisors = [b for b in (32, 64, 128, 256, 512) if self.d_in % b == 0]
            raise ValueError(
                f"quant_buffer: quant_block {self.quant_block} must divide "
                f"d_in {self.d_in} (scales are per contiguous feature "
                f"block); try one of {divisors or 'a divisor of d_in'}")

    def check_buffer(self) -> None:
        """Raise :class:`ValueError` for a replay buffer this config cannot
        build: a ``seq_len`` below 2 or a buffer smaller than two batches."""
        rows_per_seq = self.seq_len - 1
        if rows_per_seq < 1:
            raise ValueError(f"the replay buffer needs seq_len >= 2 (BOS is dropped), "
                             f"got {self.seq_len}")
        size = self.batch_size * self.buffer_mult // rows_per_seq * rows_per_seq
        if size < 2 * self.batch_size:
            raise ValueError(f"buffer_size {size} < 2×batch_size; raise buffer_mult")

    # --- derived quantities ---
    @property
    def total_steps(self) -> int:
        """Optimizer steps for the token budget (reference trainer.py:14)."""
        return self.num_tokens // self.batch_size

    @property
    def aux_mask_cadence(self) -> int:
        """Resolved dead-mask refresh cadence (``aux_mask_every``; 0 means
        the ``log_every`` interval)."""
        return self.aux_mask_every if self.aux_mask_every >= 1 else self.log_every

    @property
    def resample_threshold_steps(self) -> int:
        """Deadness threshold for resampling (``resample_dead_steps``,
        falling back to ``aux_dead_steps``)."""
        return self.resample_dead_steps or self.aux_dead_steps

    @property
    def n_layers_hooked(self) -> int:
        return max(1, len(self.hook_points))

    @property
    def n_sources(self) -> int:
        """The crosscoder's source axis: models × hooked layers."""
        return self.n_models * self.n_layers_hooked

    def resolved_hook_points(self) -> tuple[str, ...]:
        return self.hook_points if self.hook_points else (self.hook_point,)

    # --- (de)serialization ---
    def to_dict(self) -> dict[str, Any]:
        """Flat JSON-ready dict using the reference's key names."""
        d = dataclasses.asdict(self)
        extras = d.pop("extras")
        d["hook_points"] = list(self.hook_points)
        d.update(extras)
        return d

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "CrossCoderConfig":
        """Build from a flat dict; unknown keys are kept in ``extras``."""
        known = {f.name for f in dataclasses.fields(cls)} - {"extras"}
        kwargs = {k: v for k, v in d.items() if k in known}
        extras = {k: v for k, v in d.items() if k not in known}
        return cls(**kwargs, extras=extras)

    def to_json_str(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    def to_json(self, path: str | Path) -> None:
        Path(path).write_text(self.to_json_str())

    @classmethod
    def from_json(cls, path: str | Path) -> "CrossCoderConfig":
        return cls.from_dict(json.loads(Path(path).read_text()))

    def replace(self, **kwargs: Any) -> "CrossCoderConfig":
        return dataclasses.replace(self, **kwargs)

    @classmethod
    def from_cli(cls, argv: list[str] | None = None,
                 base: "CrossCoderConfig | None" = None) -> "CrossCoderConfig":
        """Every field as a ``--kebab-case`` flag over ``base`` (or the
        defaults, or ``--config-json``), as the JAX package's ``from_cli``
        does. Tuple fields take comma-separated lists, bools
        1/0/true/false/yes/no/on/off."""
        base = base or cls()
        parser = argparse.ArgumentParser(description="crosscoder_tpu_torch training config")
        parser.add_argument("--config-json", type=str, default=None,
                            help="load a cfg JSON before applying flags")
        for f in dataclasses.fields(cls):
            if f.name == "extras":
                continue
            val = getattr(base, f.name)
            flag = f"--{f.name.replace('_', '-')}"
            if isinstance(val, bool):
                parser.add_argument(flag, type=_parse_bool, default=None)
            elif isinstance(val, tuple):
                parser.add_argument(flag, type=str, default=None, help="comma-separated list")
            elif isinstance(val, int):
                parser.add_argument(flag, type=int, default=None)
            elif isinstance(val, float):
                parser.add_argument(flag, type=float, default=None)
            else:
                parser.add_argument(flag, type=str, default=None)
        ns = parser.parse_args(argv)
        if ns.config_json:
            base = cls.from_json(ns.config_json)
        # the JAX package's resolution order: defaults → --config-json →
        # TUNED.json knobs → explicit flags, so a flag always overrides a
        # pinned knob; --tuned "" clears an artifact a config JSON carried
        tuned_path = ns.tuned if ns.tuned is not None else base.tuned
        if tuned_path:
            from crosscoder_tpu_torch.tune.artifact import apply_tuned

            base = apply_tuned(base, tuned_path)
        elif ns.tuned == "":
            base = base.replace(tuned="")
        overrides: dict[str, Any] = {}
        for f in dataclasses.fields(cls):
            if f.name == "extras":
                continue
            v = getattr(ns, f.name, None)
            if v is not None:
                if isinstance(getattr(base, f.name), tuple):
                    v = tuple(x for x in v.split(",") if x)
                overrides[f.name] = v
        return base.replace(**overrides) if overrides else base


def _parse_bool(s: str) -> bool:
    low = s.lower()
    if low in ("1", "true", "yes", "on"):
        return True
    if low in ("0", "false", "no", "off"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {s!r}")


def parse_hook_point(hook_point: str) -> tuple[int, str]:
    """Parse 'blocks.{L}.hook_{site}' → (L, site)."""
    parts = hook_point.split(".")
    if len(parts) != 3 or parts[0] != "blocks" or not parts[2].startswith("hook_"):
        raise ValueError(f"unsupported hook point {hook_point!r}; expected 'blocks.N.hook_<site>'")
    return int(parts[1]), parts[2][len("hook_"):]
