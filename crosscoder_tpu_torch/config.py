"""Typed configuration, ported from :mod:`crosscoder_tpu.config`.

:class:`CrossCoderConfig` keeps every field name and default of the JAX
dataclass, so a cfg JSON written by either package loads in the other.
Validation is ported for the fields the serving slice reads
(``enc_dtype``, ``activation``, ``page_size``, ``seq_len`` and the
``serve_*`` knobs); the training knobs are carried as plain values until
the training slice ports the code that reads them. ``from_cli`` waits for
that slice too.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any

from crosscoder_tpu_torch.utils.dtypes import DTYPES

DTYPE_NAMES = tuple(DTYPES)

_ACTIVATIONS = ("relu", "topk", "jumprelu", "batchtopk")


def _check_choice(field_name: str, value: Any, choices: tuple[str, ...]) -> None:
    if value not in choices:
        raise ValueError(f"{field_name} must be {'|'.join(choices)}, got {value!r}")


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

    # --- derived quantities ---
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


def parse_hook_point(hook_point: str) -> tuple[int, str]:
    """Parse 'blocks.{L}.hook_{site}' → (L, site)."""
    parts = hook_point.split(".")
    if len(parts) != 3 or parts[0] != "blocks" or not parts[2].startswith("hook_"):
        raise ValueError(f"unsupported hook point {hook_point!r}; expected 'blocks.N.hook_<site>'")
    return int(parts[1]), parts[2][len("hook_"):]
