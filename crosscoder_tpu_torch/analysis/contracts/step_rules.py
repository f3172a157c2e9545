"""Step contract rules over the recorded eager step: the port's counterpart
of :mod:`crosscoder_tpu.analysis.contracts.hlo_rules`.

The JAX package lowers each step variant to StableHLO and checks the text.
The port runs every step eagerly, so its step program is what the step
issues: its stream of aten ops (each with its outputs' shapes, dtypes and
devices) plus its kernel launches, which go through ctypes and are counted
by each wrapper (:func:`crosscoder_tpu_torch.tune.calibrate.kernel_counters`).
:func:`record_step` runs one step body once, the way the tuner's gate
builds it (``tune/calibrate.py`` :func:`step_inputs`) and with
``donate=True`` as the ``Trainer`` calls it, under a
``TorchDispatchMode`` that records every aten op (the backward's too),
every tensor made from host data, and each state leaf's storage before and
after. The ``profiler`` namespace's annotation ops (``record_function``'s
enter and exit) are left out of the stream: they mark spans and compute
nothing. The rules are pure functions of :class:`StepContext`, so the
mutation self-tests (``mutations.py``) seed violations without running a
step:

- **knob-off identity** (and its six named splits: refill overlap,
  elastic, elastic grow, fleet, serve, tuned): a knob present but off
  issues the identical op stream and the same launches;
- **no int8 when quant is off** / **no f64** anywhere: dtype hygiene;
- **donation honored**: every state leaf keeps its storage across the
  step (the update writes in place);
- **fused / serve no dense pre-acts**: with the fused encoder live, no op
  output of shape ``[B, dict]`` (in a float type) exists. The plain
  versions of the fused kernels build ``[B, dict]`` by design
  (``ops/fused_encoder_topk.py`` ``fused_topk_encode_plain``), so these
  variants are recorded on ``cuda`` only; on the CPU the two rules land in
  ``Report.skipped``, never in ``checked``;
- **no host transfers**: no ``_local_scalar_dense``, other syncing op
  (``nonzero``, ``masked_select``, ...) or copy between the host and the
  card on a device tensor inside the step;
- **no large host consts**: no tensor over :data:`LARGE_CONST_BYTES` made
  from host data (``lift_fresh``, a host-to-device copy) inside the step.

Probe geometry (as in the JAX package): the ``[B, dict]`` scan needs every
distinguished dimension distinct (``B != n·d != dict != k``).
"""

from __future__ import annotations

import tempfile
from dataclasses import dataclass, field
from typing import Any

from crosscoder_tpu_torch.analysis.contracts.engine import Finding, Rule

# a tensor this large made from host data inside the step is a bug: step
# inputs arrive as arguments, never rebuilt from host data every step (the
# JAX package's captured-constant threshold)
LARGE_CONST_BYTES = 1 << 18

# ops that wait for the card and bring a value to the host when their input
# lives on it
SYNC_OPS = frozenset({
    "aten::_local_scalar_dense", "aten::item", "aten::nonzero",
    "aten::nonzero_static", "aten::masked_select", "aten::is_nonzero",
    "aten::equal", "aten::unique_consecutive", "aten::_unique",
    "aten::_unique2", "aten::unique_dim", "aten::bincount",
    "aten::repeat_interleave",
})
# ops whose output may be made from the host's data
_COPY_OPS = frozenset({"aten::_to_copy", "aten::copy_", "aten::_copy_from",
                       "aten::to"})
_FLOATS = ("float32", "bfloat16", "float16")
_IGNORED_NAMESPACES = ("profiler::",)
# positions of the serve encode's captured hooks (it reads each row's last
# valid one)
SERVE_SEQ = 8


@dataclass(frozen=True)
class TensorMeta:
    """A tensor as the rules see it."""

    shape: tuple[int, ...]
    dtype: str                   # torch dtype name without "torch."
    device: str                  # device type: "cpu", "cuda"
    nbytes: int

    def __str__(self) -> str:
        return f"{self.dtype}{list(self.shape)}@{self.device}"


@dataclass(frozen=True)
class OpRecord:
    """One recorded aten op: its name (``aten::mm.default``) and its
    tensor inputs and outputs."""

    name: str
    inputs: tuple[TensorMeta, ...] = ()
    outputs: tuple[TensorMeta, ...] = ()

    def __str__(self) -> str:
        return (f"{self.name}({', '.join(map(str, self.inputs))}) -> "
                f"({', '.join(map(str, self.outputs))})")


@dataclass
class VariantMeta:
    """What the checks need to know about one recorded variant."""

    n_donated_leaves: int = 0
    quant_off: bool = True                  # no int8 may appear
    forbid_dense_shape: tuple[int, int] | None = None   # (B, dict) if fused
    serve_step: bool = False                # the serve encode, not a train step


@dataclass
class StepRecord:
    """One recorded step: the op stream, the launches by kernel counter,
    the tensors made from host data ``(nbytes, description)``, the state
    leaves whose storage did not survive the step, the number of leaves,
    and the step's result (``state``, ``loss``; the serve step's
    ``outputs``)."""

    ops: list[OpRecord] = field(default_factory=list)
    launches: dict[str, int] = field(default_factory=dict)
    host_consts: list[tuple[int, str]] = field(default_factory=list)
    moved: list[str] = field(default_factory=list)
    n_leaves: int = 0
    state: Any = None
    loss: Any = None
    outputs: Any = None


@dataclass
class StepContext:
    """Recorded step variants for the step rules."""

    ops: dict[str, list[OpRecord]] = field(default_factory=dict)
    launches: dict[str, dict[str, int]] = field(default_factory=dict)
    meta: dict[str, VariantMeta] = field(default_factory=dict)
    # label -> [(nbytes, description)] of tensors made from host data
    host_consts: dict[str, list[tuple[int, str]]] = field(default_factory=dict)
    # label -> state leaves whose storage the step replaced
    moved: dict[str, list[str]] = field(default_factory=dict)
    # (label_a, label_b, what-knob) pairs that must record the same program
    identity_pairs: list[tuple[str, str, str]] = field(default_factory=list)
    device: str = "cpu"
    # rule name -> why it cannot be checked on this device
    skip_reasons: dict[str, str] = field(default_factory=dict)

    def add(self, label: str, rec: StepRecord, meta: VariantMeta) -> str:
        self.ops[label] = rec.ops
        self.launches[label] = rec.launches
        self.host_consts[label] = rec.host_consts
        self.moved[label] = rec.moved
        self.meta[label] = meta
        return label


# ---------------------------------------------------------------------------
# recording (the only part that touches torch or the card)


def _meta(t) -> TensorMeta:
    return TensorMeta(tuple(int(d) for d in t.shape), str(t.dtype).removeprefix("torch."),
                      t.device.type, int(t.numel()) * t.element_size())


def _tensors(obj) -> list:
    import torch

    out = []
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            out.extend(_tensors(o))
    elif isinstance(obj, dict):
        for o in obj.values():
            out.extend(_tensors(o))
    return out


def _recorder():
    """A ``TorchDispatchMode`` that appends an :class:`OpRecord` for every
    aten op to ``.ops`` and notes the tensors made from host data in
    ``.host_consts``."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Recorder(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops: list[OpRecord] = []
            self.host_consts: list[tuple[int, str]] = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            name = f"{func._schema.name}.{func._overloadname}"
            if name.startswith(_IGNORED_NAMESPACES):
                return out
            ins = tuple(_meta(t) for t in _tensors((args, kwargs)))
            outs = tuple(_meta(t) for t in _tensors(out))
            self.ops.append(OpRecord(name, ins, outs))
            base = name.rsplit(".", 1)[0]
            if base == "aten::lift_fresh" or (
                    base in _COPY_OPS and any(i.device == "cpu" for i in ins)
                    and any(o.device != "cpu" for o in outs)):
                self.host_consts.extend((o.nbytes, f"{base} -> {o}") for o in outs)
            return out

    return Recorder()


def _leaves(state) -> dict[str, Any]:
    out = {f"params/{k}": v for k, v in state.params.items()}
    out.update({f"mu/{k}": v for k, v in state.opt_state.mu.items()})
    out.update({f"nu/{k}": v for k, v in state.opt_state.nu.items()})
    out.update({f"aux/{k}": v for k, v in (state.aux or {}).items()})
    return out


def _storage(t) -> tuple[int, int]:
    return (t.untyped_storage().data_ptr(), t.storage_offset())


def _launches() -> dict[str, int]:
    from crosscoder_tpu_torch.tune.calibrate import kernel_counters

    return {k: int(c.launches) for k, c in kernel_counters().items()}


def _launch_diff(before: dict[str, int], after: dict[str, int]) -> dict[str, int]:
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def record_step(cfg, device=None) -> StepRecord:
    """Run ``cfg``'s first step body once, from its seeded initial state on
    a batch drawn on the device from ``cfg.seed``
    (:func:`crosscoder_tpu_torch.tune.calibrate.step_inputs`), with
    ``donate=True`` as the ``Trainer`` calls it, and record it. Runs on
    ``cuda`` unless ``device`` names another device."""
    import torch

    from crosscoder_tpu_torch.tune.calibrate import step_inputs
    from crosscoder_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    fn, state, batch, scale = step_inputs(cfg, dev)
    leaves = _leaves(state)
    before_ptr = {k: _storage(v) for k, v in leaves.items()}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    before = _launches()
    with _recorder() as rec:
        new_state, metrics = fn(state, batch, scale, donate=True)
    after = _launches()
    new_leaves = _leaves(new_state)
    moved = sorted(k for k, ptr in before_ptr.items()
                   if k not in new_leaves or _storage(new_leaves[k]) != ptr)
    return StepRecord(ops=rec.ops, launches=_launch_diff(before, after),
                      host_consts=rec.host_consts, moved=moved, n_leaves=len(leaves),
                      state=new_state, loss=metrics["loss"])


def record_serve_step(cfg, device=None) -> StepRecord:
    """Record the serve encode step (``serve/step.py``
    :func:`encode_topk_diff`) at ``cfg``'s batch and dictionary, on random
    captured hooks of :data:`SERVE_SEQ` positions drawn from ``cfg.seed``,
    with the fused encoder the engine takes. Runs on ``cuda`` unless
    ``device`` names another device."""
    import torch

    from crosscoder_tpu_torch.models import crosscoder
    from crosscoder_tpu_torch.serve.step import diff_pair, encode_topk_diff
    from crosscoder_tpu_torch.utils.device import resolve_device
    from crosscoder_tpu_torch.utils.dtypes import dtype_of

    dev = resolve_device(device)
    params = crosscoder.init_params(cfg, seed=cfg.seed, device=dev)
    gen = torch.Generator(device=dev).manual_seed(int(cfg.seed))
    B, n = cfg.batch_size, cfg.n_sources
    captures = torch.randn((B, SERVE_SEQ, n, cfg.d_in), generator=gen,
                           device=dev).to(dtype_of(cfg.enc_dtype))
    lengths = torch.randint(1, SERVE_SEQ + 1, (B,), generator=gen, device=dev,
                            dtype=torch.int32)
    norm = torch.ones(n, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    before = _launches()
    with _recorder() as rec:
        out = encode_topk_diff(params, captures, lengths, norm, enc_dtype=cfg.enc_dtype,
                               k=cfg.topk_k, pair=diff_pair(n, cfg.n_models))
    return StepRecord(ops=rec.ops, launches=_launch_diff(before, _launches()),
                      host_consts=rec.host_consts, outputs=out)


def train_meta(cfg, rec: StepRecord, **kw) -> VariantMeta:
    return VariantMeta(n_donated_leaves=rec.n_leaves,
                       quant_off=not (cfg.quant_encoder or cfg.quant_grads), **kw)


def _cfg(**kw):
    from crosscoder_tpu_torch.config import CrossCoderConfig

    base = dict(d_in=8, dict_size=32, batch_size=32, enc_dtype="fp32")
    base.update(kw)
    return CrossCoderConfig(**base)


def knob_off_lattice(tmp: str | None = None) -> tuple[tuple[str, dict[str, Any]], ...]:
    """The JAX package's ``KNOB_OFF_LATTICE`` (``hlo_rules.py``): each
    entry ``(label, overrides)`` must record the identical step program as
    the bare baseline. Its paths are under ``tmp`` (default the
    temporary directory, ``/tmp`` as in the JAX package)."""
    t = tempfile.gettempdir() if tmp is None else tmp
    return (
        ("quant", dict(quant_buffer=True, quant_block=8)),
        ("obs", dict(obs="on", obs_dir=f"{t}/obs", profile_steps="3:5",
                     log_print_every=7)),
        ("paged_harvest", dict(harvest_runtime="paged", page_size=16,
                               seq_len=1024)),
        ("resilience", dict(guard_loss=True, harvest_timeout_s=2.0,
                            keep_saves=2)),
        ("logging", dict(log_backend="jsonl", profile_dir=f"{t}/prof")),
        ("refill_overlap", dict(refill_overlap="on", refill_dispatch_batch=8)),
        ("elastic", dict(elastic="on", elastic_heartbeat_s=2.0,
                         elastic_grace_s=9.0)),
        ("elastic_grow", dict(elastic="on", elastic_grow="on",
                              checkpoint_dir=f"{t}/ckpt",
                              elastic_suspect_probes=3, elastic_dwell_steps=5,
                              elastic_grow_debounce=4, elastic_policy="score")),
        ("fleet", dict(fleet="on", fleet_tenants="a:seed=1;b:seed=2",
                       fleet_max_buckets=4, checkpoint_dir=f"{t}/ckpt")),
        ("serve", dict(serve="on", serve_max_batch=8, serve_max_wait_ms=2.0,
                       serve_queue=32, serve_shed_ms=50.0)),
        ("compile_cache", dict(compile_cache_dir=f"{t}/compile_cache_contract",
                               compile_cache_max_bytes=1 << 20,
                               compile_cache_verify="strict")),
        ("all_knobs", dict(quant_buffer=True, quant_block=8, obs="on",
                           harvest_runtime="paged", page_size=16, seq_len=1024,
                           guard_loss=True, log_backend="jsonl",
                           refill_overlap="on", refill_dispatch_batch=8,
                           elastic="on", elastic_grow="on", serve="on",
                           compile_cache_dir=f"{t}/compile_cache_contract",
                           checkpoint_dir=f"{t}/ckpt")),
    )


# the sparse/fused tiers: "off" vs a dead "auto" (no kernel live) must be
# identical — the knob's PRESENCE costs nothing
_SPARSE_SHAPE = dict(d_in=128, dict_size=256, batch_size=32, topk_k=8,
                     l1_coeff=0.0)
# all distinguished dims distinct: B=192, n·d=256, dict=1024, k=8
_FUSED_SHAPE = dict(d_in=128, dict_size=1024, batch_size=192, topk_k=8,
                    l1_coeff=0.0)
FUSED_RULES = ("step-fused-no-dense-preacts", "step-serve-no-dense-preacts")
CPU_FUSED_REASON = ("the fused encoder's plain versions build [B, dict] by design "
                    "(ops/fused_encoder_topk.py); its kernels run on cuda only")


def add_fused_live(ctx: StepContext, cfg, device, label: str = "topk:fused_live",
                   serve_cfg=None) -> None:
    """Record the fused-live train variant ``cfg`` and, with ``serve_cfg``,
    the fused-live serve encode, each forbidding its ``[B, dict]``
    float tensor."""
    rec = record_step(cfg, device)
    ctx.add(label, rec, train_meta(cfg, rec, forbid_dense_shape=(cfg.batch_size,
                                                                  cfg.dict_size)))
    if serve_cfg is not None:
        srec = record_serve_step(serve_cfg, device)
        ctx.add("serve:encode_fused", srec, VariantMeta(
            serve_step=True, forbid_dense_shape=(serve_cfg.batch_size, serve_cfg.dict_size)))


def build_step_context(device=None, full: bool = True,
                       base: dict[str, Any] | None = None) -> StepContext:
    """Record the JAX package's variant lattice: the bare baseline, each
    present-but-off knob of :func:`knob_off_lattice`, a real
    ``TUNED.json`` of default knobs, and fused and sparse "off" against
    "auto"-dead at ``_SPARSE_SHAPE``, with JAX's labels and identity
    pairs. ``base`` (config fields) moves the baseline, the knob-off
    variants and the tuned one from JAX's tiny config to another (a
    full-width one on the card); the "auto"-dead pairs stay at
    ``_SPARSE_SHAPE``, where "auto" is dead. With ``full`` on ``cuda``,
    also the fused-live train variant and serve encode at
    ``_FUSED_SHAPE``; on the CPU their rules are skipped
    (:data:`CPU_FUSED_REASON`). Runs on ``cuda`` unless ``device`` names
    another device."""
    from crosscoder_tpu_torch.config import CrossCoderConfig
    from crosscoder_tpu_torch.tune.artifact import TunedArtifact, apply_tuned
    from crosscoder_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    ctx = StepContext(device=dev.type)

    def lattice_cfg(**kw):
        return _cfg(**kw) if base is None else CrossCoderConfig(**{**base, **kw})

    def add(label, cfg, **meta_kw):
        rec = record_step(cfg, dev)
        return ctx.add(label, rec, train_meta(cfg, rec, **meta_kw))

    add("base", lattice_cfg())
    for label, overrides in knob_off_lattice():
        add(f"off:{label}", lattice_cfg(**overrides))
        ctx.identity_pairs.append(("base", f"off:{label}", label))
    with tempfile.TemporaryDirectory(prefix="contracts_tuned_") as td:
        art = TunedArtifact(
            objective="train",
            knobs={"refill_frac": 0.5, "refill_dispatch_batch": 4,
                   "prefetch": True, "quant_buffer": False},
            mesh={"n_devices": 1, "n_model": 1},
        )
        path = art.save(f"{td}/TUNED.json")
        add("off:tuned", apply_tuned(lattice_cfg(), path))
        ctx.identity_pairs.append(("base", "off:tuned", "tuned"))
    for act in ("topk", "batchtopk"):
        a = add(f"{act}:fused_off",
                _cfg(activation=act, fused_encoder="off", **_SPARSE_SHAPE))
        b = add(f"{act}:fused_auto_dead",
                _cfg(activation=act, fused_encoder="auto", **_SPARSE_SHAPE))
        ctx.identity_pairs.append((a, b, f"fused_encoder[{act}]"))
    a = add("topk:sparse_off",
            _cfg(activation="topk", sparse_bwd="off", **_SPARSE_SHAPE))
    b = add("topk:sparse_auto_dead",
            _cfg(activation="topk", sparse_bwd="auto", **_SPARSE_SHAPE))
    ctx.identity_pairs.append((a, b, "sparse_bwd"))

    if full and dev.type == "cuda":
        cfg = _cfg(activation="topk", fused_encoder="on", sparse_bwd="on", **_FUSED_SHAPE)
        add_fused_live(ctx, cfg, dev, serve_cfg=cfg.replace(serve="on"))
    elif full:
        ctx.skip_reasons.update(dict.fromkeys(FUSED_RULES, CPU_FUSED_REASON))
    return ctx


def same_program(ctx: StepContext, a: str, b: str) -> bool:
    return ctx.ops[a] == ctx.ops[b] and ctx.launches[a] == ctx.launches[b]


def first_difference(ctx: StepContext, a: str, b: str) -> str:
    """Where two recorded programs first part: an op index or the launches."""
    for i, (x, y) in enumerate(zip(ctx.ops[a], ctx.ops[b])):
        if x != y:
            return f"op {i}: {x} vs {y}"
    if len(ctx.ops[a]) != len(ctx.ops[b]):
        return f"{len(ctx.ops[a])} vs {len(ctx.ops[b])} ops"
    return f"launches {ctx.launches[a]} vs {ctx.launches[b]}"


# ---------------------------------------------------------------------------
# rules (pure functions of StepContext)


def _is_step_ctx(ctx: Any) -> bool:
    return isinstance(ctx, StepContext) and bool(ctx.ops)


def _has_dense_forbid(serve: bool):
    def applies(ctx: Any) -> bool:
        return _is_step_ctx(ctx) and any(
            m.forbid_dense_shape is not None and m.serve_step == serve
            for m in ctx.meta.values())
    return applies


def _identity_findings(ctx: StepContext, rule: str, knob: str | None,
                       message: str) -> list[Finding]:
    out = []
    for a, b, k in ctx.identity_pairs:
        if (knob is not None and k != knob) or same_program(ctx, a, b):
            continue
        out.append(Finding(rule=rule, location=f"{a} vs {b}",
                           message=message.format(knob=k) + f" ({first_difference(ctx, a, b)})"))
    return out


def _check_identity(ctx: StepContext) -> list[Finding]:
    return _identity_findings(
        ctx, "step-knob-off-identity", None,
        "knob '{knob}' present-but-off changes the recorded step (op stream "
        "or kernel launches) — the zero-cost-off contract is broken")


def _named_identity(rule: str, knob: str, what: str):
    def check(ctx: StepContext) -> list[Finding]:
        return _identity_findings(
            ctx, rule, knob, f"{what} changed the recorded step program — "
                             f"it must be invisible to the step")
    return check


def _check_no_s8(ctx: StepContext) -> list[Finding]:
    out = []
    for label, ops in ctx.ops.items():
        if not ctx.meta[label].quant_off:
            continue
        hits = [op for op in ops if any(o.dtype == "int8" for o in op.outputs)]
        if hits:
            out.append(Finding(
                rule="step-no-s8-when-quant-off", location=label,
                message=f"int8 tensor in a quant-off step variant "
                        f"({len(hits)} ops, first {hits[0]})",
            ))
    return out


def _check_no_f64(ctx: StepContext) -> list[Finding]:
    out = []
    for label, ops in ctx.ops.items():
        hits = [op for op in ops
                if any(t.dtype == "float64" for t in op.inputs + op.outputs)]
        if hits:
            out.append(Finding(
                rule="step-no-f64", location=label,
                message=f"f64 tensor in the step ({len(hits)} ops, first "
                        f"{hits[0]}) — a silent 2x bytes/flops upcast",
            ))
    return out


def _check_donation(ctx: StepContext) -> list[Finding]:
    out = []
    for label, moved in ctx.moved.items():
        want = ctx.meta[label].n_donated_leaves
        if moved:
            out.append(Finding(
                rule="step-donation-honored", location=label,
                message=f"only {want - len(moved)}/{want} donated train-state "
                        f"leaves kept their storage ({', '.join(moved)} "
                        f"replaced) — a dropped donation silently doubles "
                        f"that leaf's memory",
            ))
    return out


def _dense_hits(ops: list[OpRecord], shape: tuple[int, int]) -> list[OpRecord]:
    return [op for op in ops if any(
        len(o.shape) >= 2 and o.shape[-2:] == tuple(shape) and o.dtype in _FLOATS
        for o in op.outputs)]


def _check_fused_no_dense(ctx: StepContext) -> list[Finding]:
    out = []
    for label, ops in ctx.ops.items():
        shape = ctx.meta[label].forbid_dense_shape
        if shape is None or ctx.meta[label].serve_step:
            continue
        hits = _dense_hits(ops, shape)
        if hits:
            out.append(Finding(
                rule="step-fused-no-dense-preacts", location=label,
                message=f"{len(hits)} [B={shape[0]}, dict={shape[1]}] tensors "
                        f"in a fused-encoder-live step (first {hits[0]}) — "
                        f"the pre-act matrix the fusion exists to never "
                        f"materialize",
            ))
    return out


def _check_serve_no_dense(ctx: StepContext) -> list[Finding]:
    out = []
    for label, ops in ctx.ops.items():
        shape = ctx.meta[label].forbid_dense_shape
        if shape is None or not ctx.meta[label].serve_step:
            continue
        hits = _dense_hits(ops, shape)
        if hits:
            out.append(Finding(
                rule="step-serve-no-dense-preacts", location=label,
                message=f"{len(hits)} [B={shape[0]}, dict={shape[1]}] tensors "
                        f"in the fused-live serve encode step (first "
                        f"{hits[0]}) — the dense pre-act matrix must never "
                        f"materialize on the request path",
            ))
    return out


def _is_transfer(op: OpRecord) -> bool:
    base = op.name.rsplit(".", 1)[0]
    on_device = [t for t in op.inputs if t.device != "cpu"]
    if base in SYNC_OPS:
        return bool(on_device)
    if base in _COPY_OPS:
        devs = {t.device for t in op.inputs + op.outputs}
        return "cpu" in devs and len(devs) > 1
    return False


def _check_host_transfers(ctx: StepContext) -> list[Finding]:
    out = []
    for label, ops in ctx.ops.items():
        for op in ops:
            if _is_transfer(op):
                out.append(Finding(
                    rule="step-no-host-transfers", location=label,
                    message=f"host transfer {op} inside the step (steps must "
                            f"stay on the device; telemetry reads host-side "
                            f"only)",
                ))
    return out


def _check_large_consts(ctx: StepContext) -> list[Finding]:
    out = []
    for label, consts in ctx.host_consts.items():
        for nbytes, descr in consts:
            if nbytes > LARGE_CONST_BYTES:
                out.append(Finding(
                    rule="step-no-large-host-consts", location=label,
                    message=f"the step makes a {nbytes}-byte tensor from "
                            f"host data ({descr}; > {LARGE_CONST_BYTES}) — "
                            f"rebuilt every step instead of passed as an "
                            f"argument",
                ))
    return out


STEP_RULES: list[Rule] = [
    Rule("step-knob-off-identity",
         "present-but-off knobs record the identical step program",
         _is_step_ctx, _check_identity),
    Rule("step-no-s8-when-quant-off",
         "no int8 tensor appears in any quant-off step variant",
         _is_step_ctx, _check_no_s8),
    Rule("step-no-f64",
         "no f64 tensor appears in any step variant",
         _is_step_ctx, _check_no_f64),
    Rule("step-donation-honored",
         "every donated train-state leaf keeps its storage",
         _is_step_ctx, _check_donation),
    Rule("step-fused-no-dense-preacts",
         "fused-encoder-live variants contain no [B, dict] tensor (cuda)",
         _has_dense_forbid(False), _check_fused_no_dense),
    Rule("step-no-host-transfers",
         "no sync or host<->device copy of a device tensor inside the step",
         _is_step_ctx, _check_host_transfers),
    Rule("step-no-large-host-consts",
         "the step makes no large tensor from host data",
         _is_step_ctx, _check_large_consts),
    Rule("step-refill-overlap-off-identity",
         "the refill overlap engine never changes the step",
         _is_step_ctx, _named_identity("step-refill-overlap-off-identity", "refill_overlap",
                                       "refill_overlap/refill_dispatch_batch")),
    Rule("step-elastic-off-identity",
         "elastic membership never changes the step",
         _is_step_ctx, _named_identity("step-elastic-off-identity", "elastic",
                                       "elastic/elastic_heartbeat_s/elastic_grace_s")),
    Rule("step-elastic-grow-off-identity",
         "the elastic scale-up plane never changes the step",
         _is_step_ctx, _named_identity("step-elastic-grow-off-identity", "elastic_grow",
                                       "elastic_grow/suspect_probes/dwell/debounce/policy")),
    Rule("step-fleet-off-identity",
         "the multi-tenant fleet scheduler never changes the step",
         _is_step_ctx, _named_identity("step-fleet-off-identity", "fleet",
                                       "fleet/fleet_tenants/fleet_max_buckets")),
    Rule("step-serve-off-identity",
         "the serving plane never changes the train step",
         _is_step_ctx, _named_identity("step-serve-off-identity", "serve",
                                       "serve/serve_max_batch/serve_max_wait_ms/"
                                       "serve_queue/serve_shed_ms")),
    Rule("step-serve-no-dense-preacts",
         "the fused-live serve encode step carries no [B, dict] tensor (cuda)",
         _has_dense_forbid(True), _check_serve_no_dense),
    Rule("step-tuned-config-identity",
         "a default-knob TUNED.json never changes the step",
         _is_step_ctx, _named_identity("step-tuned-config-identity", "tuned",
                                       "a TUNED.json carrying the default knob values")),
]

# the rules the tuner's gate runs on a candidate against its projection
GATE_RULES = ("step-knob-off-identity", "step-no-s8-when-quant-off", "step-no-f64")


def gate_context(candidate: StepRecord, cand_cfg, projection: StepRecord | None,
                 proj_cfg=None) -> StepContext:
    """The tuner's gate context: the candidate's recorded step and, where
    its projection differs, the projection's, as the identity pair
    ``tune:step_projection`` vs ``tune:candidate`` (JAX's
    ``contracts_gate`` labels)."""
    ctx = StepContext()
    ctx.add("tune:candidate", candidate, train_meta(cand_cfg, candidate))
    if projection is not None:
        ctx.add("tune:step_projection", projection, train_meta(proj_cfg, projection))
        ctx.identity_pairs.append(("tune:step_projection", "tune:candidate",
                                   "tune-data-plane"))
    return ctx


def rules_named(names) -> list[Rule]:
    return [r for r in STEP_RULES if r.name in names]

