"""Mutation self-tests: one deliberately broken fixture per rule, ported
from :mod:`crosscoder_tpu.analysis.contracts.mutations`.

A checker that cannot fail is not a check. Every rule of the port ships a
seeded violation here (a synthetic context carrying exactly the defect the
rule exists to catch), and ``tests/test_torch_contracts.py`` asserts each
one fires and that the shipped tree stays clean. ``python -m
crosscoder_tpu_torch.analysis.contracts --mutate <rule>`` runs a fixture
from the CLI and exits nonzero when the rule fires, which is the expected
outcome.

All fixtures are pure data (no torch, no card): the rules are pure
functions of their contexts.
"""

from __future__ import annotations

from typing import Any, Callable

from crosscoder_tpu_torch.analysis.contracts.ast_lints import AST_RULES, SourceContext
from crosscoder_tpu_torch.analysis.contracts.cache_keys import CACHE_RULES, CacheKeyContext
from crosscoder_tpu_torch.analysis.contracts.engine import Report, Rule, run_rules
from crosscoder_tpu_torch.analysis.contracts.kernel_safety import (KERNEL_RULES,
                                                                   CapturedLaunch,
                                                                   KernelContext)
from crosscoder_tpu_torch.analysis.contracts.step_rules import (STEP_RULES, OpRecord,
                                                                StepContext, TensorMeta,
                                                                VariantMeta)

ALL_RULES: list[Rule] = STEP_RULES + KERNEL_RULES + AST_RULES + CACHE_RULES


def _t(shape, dtype="float32", device="cuda") -> TensorMeta:
    n = 1
    for d in shape:
        n *= d
    size = {"float64": 8, "int64": 8, "float32": 4, "int32": 4, "bfloat16": 2,
            "int8": 1, "bool": 1}[dtype]
    return TensorMeta(tuple(shape), dtype, device, n * size)


_CLEAN_OPS = [
    OpRecord("aten::mm.default", (_t((8, 4)), _t((4, 4))), (_t((8, 4)),)),
    OpRecord("aten::add_.Tensor", (_t((8, 4)), _t((8, 4))), (_t((8, 4)),)),
]


def _step_ctx() -> StepContext:
    return StepContext(ops={"base": list(_CLEAN_OPS)},
                       launches={"base": {"topk_mask": 1}},
                       meta={"base": VariantMeta(n_donated_leaves=1)},
                       host_consts={"base": []}, moved={"base": []}, device="cuda")


def _with_off_variant(knob: str) -> StepContext:
    ctx = _step_ctx()
    label = f"off:{knob}"
    ctx.ops[label] = list(_CLEAN_OPS) + [OpRecord("aten::clone.default", (_t((8, 4)),),
                                                  (_t((8, 4)),))]
    ctx.launches[label] = {"topk_mask": 1}
    ctx.meta[label] = VariantMeta(n_donated_leaves=1)
    ctx.host_consts[label] = []
    ctx.moved[label] = []
    ctx.identity_pairs = [("base", label, knob)]
    return ctx


def _mut_identity() -> StepContext:
    # the same ops, but the off variant launches one more kernel
    ctx = _step_ctx()
    ctx.ops["off:quant"] = list(_CLEAN_OPS)
    ctx.launches["off:quant"] = {"topk_mask": 1, "quantize_rows": 1}
    ctx.meta["off:quant"] = VariantMeta(n_donated_leaves=1)
    ctx.host_consts["off:quant"] = []
    ctx.moved["off:quant"] = []
    ctx.identity_pairs = [("base", "off:quant", "quant")]
    return ctx


def _mut_refill_overlap() -> StepContext:
    return _with_off_variant("refill_overlap")


def _mut_elastic() -> StepContext:
    return _with_off_variant("elastic")


def _mut_elastic_grow() -> StepContext:
    return _with_off_variant("elastic_grow")


def _mut_fleet() -> StepContext:
    return _with_off_variant("fleet")


def _mut_serve() -> StepContext:
    return _with_off_variant("serve")


def _mut_tuned() -> StepContext:
    return _with_off_variant("tuned")


def _dense(ctx: StepContext, serve: bool) -> StepContext:
    ctx.meta["base"] = VariantMeta(n_donated_leaves=1, serve_step=serve,
                                   forbid_dense_shape=(192, 1024))
    ctx.ops["base"].append(OpRecord("aten::mm.default", (_t((192, 256)), _t((256, 1024))),
                                    (_t((192, 1024)),)))
    return ctx


def _mut_serve_dense() -> StepContext:
    return _dense(_step_ctx(), serve=True)


def _mut_dense_preacts() -> StepContext:
    return _dense(_step_ctx(), serve=False)


def _mut_s8() -> StepContext:
    ctx = _step_ctx()
    ctx.ops["base"].append(OpRecord("aten::_to_copy.default", (_t((32, 8)),),
                                    (_t((32, 8), "int8"),)))
    return ctx


def _mut_f64() -> StepContext:
    ctx = _step_ctx()
    ctx.ops["base"].append(OpRecord("aten::_to_copy.default", (_t((4,)),),
                                    (_t((4,), "float64"),)))
    return ctx


def _mut_donation() -> StepContext:
    ctx = _step_ctx()
    ctx.meta["base"] = VariantMeta(n_donated_leaves=3)
    ctx.moved["base"] = ["aux/steps_since_fired"]     # replaced, not written in place
    return ctx


def _mut_host_transfer() -> StepContext:
    ctx = _step_ctx()
    ctx.ops["base"].append(OpRecord("aten::_local_scalar_dense.default", (_t(()),), ()))
    return ctx


def _mut_large_const() -> StepContext:
    ctx = _step_ctx()
    ctx.host_consts["base"] = [(1 << 20, "aten::_to_copy -> float32[512, 512]@cuda")]
    return ctx


_LIBS = ("topk_mask", "sparsify")


def _launch(**kw) -> CapturedLaunch:
    base = dict(library="topk_mask", kernel="topk_slice_kernel", probe="topk_mask/bf16/tail",
                grid=(13, 1, 1), block=(256, 1, 1), registers=32, smem_bytes=4096)
    base.update(kw)
    return CapturedLaunch(**base)


def _kernel_ctx(*extra: CapturedLaunch, **kw) -> KernelContext:
    ctx = KernelContext(
        launches=[_launch(), _launch(library="sparsify", kernel="sparsify_split_kernel",
                                     probe="sparsify/split/bf16/tail"), *extra],
        libraries=_LIBS,
        globals={"topk_mask": {"topk_slice_kernel"}, "sparsify": {"sparsify_split_kernel"}},
        ptxas={"topk_mask": {"topk_slice_kernel": {"registers": 32, "smem_bytes": 4096,
                                                   "spill_stores": 0, "spill_loads": 0}}},
        sanitizer={"memcheck": {"errors": 0, "rc": 0, "seconds": 1.0, "text": ""},
                   "racecheck": {"errors": 0, "rc": 0, "seconds": 1.0, "text": ""}},
        tail_bars={"topk_mask/bf16/tail": (True, "bitwise")},
        repeats={"topk_mask/bf16/tail": True})
    for k, v in kw.items():
        setattr(ctx, k, v)
    return ctx


def _mut_probe_coverage() -> KernelContext:
    # sparsify's second kernel (the warp route) was never launched
    ctx = _kernel_ctx()
    ctx.globals["sparsify"] = {"sparsify_split_kernel", "sparsify_warp_kernel"}
    return ctx


def _mut_launch_limits() -> KernelContext:
    return _kernel_ctx(_launch(block=(2048, 1, 1)))


def _mut_smem() -> KernelContext:
    return _kernel_ctx(_launch(smem_bytes=256 * 1024))


def _mut_tail_oob() -> KernelContext:
    return _kernel_ctx(sanitizer={
        "memcheck": {"errors": 1, "rc": 99, "seconds": 1.0,
                     "text": "Invalid __global__ write of size 4 bytes"},
        "racecheck": {"errors": 0, "rc": 0, "seconds": 1.0, "text": ""}})


def _mut_race() -> KernelContext:
    return _kernel_ctx(repeats={"topk_mask/bf16/tail": False})


def _mut_local_memory() -> KernelContext:
    ctx = _kernel_ctx()
    ctx.ptxas["topk_mask"]["topk_slice_kernel"].update(spill_stores=8, spill_loads=8)
    return ctx


def _src_ctx(files: dict[str, str]) -> SourceContext:
    return SourceContext(
        files=files,
        docs_text="batch_size is documented here",
        span_taxonomy=frozenset({"step", "harvest"}),
        known_gates=frozenset(),
        cfg_attrs=frozenset({"batch_size", "dict_size"}),
        cfg_fields=frozenset({"batch_size", "dict_size"}),
    )


def _mut_gate() -> SourceContext:
    return _src_ctx({"crosscoder_tpu_torch/bad.py": 'GATE = "CROSSCODER_BATCHTOK_PALLAS"\n'})


def _mut_cfg_fields() -> SourceContext:
    return _src_ctx({"crosscoder_tpu_torch/bad.py": "x = cfg.no_such_knob\n"})


def _mut_stdout_print() -> SourceContext:
    return _src_ctx({"crosscoder_tpu_torch/bad.py": 'print("leaked to stdout")\n'})


def _mut_span() -> SourceContext:
    return _src_ctx({"crosscoder_tpu_torch/bad.py":
                     'with trace.span("rogue_span"):\n    pass\n'})


def _mut_metric_key() -> SourceContext:
    return _src_ctx({"crosscoder_tpu_torch/bad.py": "reg.gauge('rogue_key', 1.0)\n"})


def _mut_unused_import() -> SourceContext:
    return _src_ctx({"crosscoder_tpu_torch/bad.py": "import os\nx = 1\n"})


def _mut_cache_key() -> CacheKeyContext:
    # a library key that ignores the headers: editing a .cuh would load the
    # stale library built from the old header
    import hashlib

    fields = frozenset({"lib/source:lib.cu", "lib/header:a.cuh", "lib/format"})

    def leaky_digest(d):
        blob = repr((d.get("lib/source:lib.cu"), d.get("lib/format")))
        return hashlib.sha256(blob.encode()).hexdigest()

    return CacheKeyContext(
        fields=fields,
        base_cfg={"lib/source:lib.cu": b"__global__ void k() {}", "lib/header:a.cuh": b"",
                  "lib/format": 1},
        digest_fn=leaky_digest,
    )


MUTATIONS: dict[str, Callable[[], Any]] = {
    "step-knob-off-identity": _mut_identity,
    "step-refill-overlap-off-identity": _mut_refill_overlap,
    "step-elastic-off-identity": _mut_elastic,
    "step-elastic-grow-off-identity": _mut_elastic_grow,
    "step-fleet-off-identity": _mut_fleet,
    "step-serve-off-identity": _mut_serve,
    "step-tuned-config-identity": _mut_tuned,
    "step-serve-no-dense-preacts": _mut_serve_dense,
    "step-no-s8-when-quant-off": _mut_s8,
    "step-no-f64": _mut_f64,
    "step-donation-honored": _mut_donation,
    "step-fused-no-dense-preacts": _mut_dense_preacts,
    "step-no-host-transfers": _mut_host_transfer,
    "step-no-large-host-consts": _mut_large_const,
    "kernel-probe-coverage": _mut_probe_coverage,
    "kernel-launch-limits": _mut_launch_limits,
    "kernel-smem-budget": _mut_smem,
    "kernel-tail-oob": _mut_tail_oob,
    "kernel-write-race": _mut_race,
    "kernel-local-memory": _mut_local_memory,
    "lint-gate-registry": _mut_gate,
    "lint-cfg-fields": _mut_cfg_fields,
    "lint-no-stdout-print": _mut_stdout_print,
    "lint-span-taxonomy": _mut_span,
    "lint-metric-keys": _mut_metric_key,
    "lint-unused-imports": _mut_unused_import,
    "cache-key-completeness": _mut_cache_key,
}

# each port rule and the JAX package's rule it ports
JAX_RULE = {
    "step-knob-off-identity": "hlo-knob-off-identity",
    "step-refill-overlap-off-identity": "hlo-refill-overlap-off-identity",
    "step-elastic-off-identity": "hlo-elastic-off-identity",
    "step-elastic-grow-off-identity": "hlo-elastic-grow-off-identity",
    "step-fleet-off-identity": "hlo-fleet-off-identity",
    "step-serve-off-identity": "hlo-serve-off-identity",
    "step-tuned-config-identity": "hlo-tuned-config-identity",
    "step-serve-no-dense-preacts": "hlo-serve-no-dense-preacts",
    "step-no-s8-when-quant-off": "hlo-no-s8-when-quant-off",
    "step-no-f64": "hlo-no-f64",
    "step-donation-honored": "hlo-donation-honored",
    "step-fused-no-dense-preacts": "hlo-fused-no-dense-preacts",
    "step-no-host-transfers": "hlo-no-host-transfers",
    "step-no-large-host-consts": "jaxpr-no-large-captured-consts",
    "kernel-probe-coverage": "pallas-probe-coverage",
    "kernel-launch-limits": "pallas-grid-blockspec-consistency",
    "kernel-smem-budget": "pallas-vmem-budget",
    "kernel-tail-oob": "pallas-indexmap-oob",
    "kernel-write-race": "pallas-write-race",
    "kernel-local-memory": "pallas-scratch-dtype",
    **{r.name: r.name for r in AST_RULES + CACHE_RULES},
}


def rule_by_name(name: str) -> Rule:
    for rule in ALL_RULES:
        if rule.name == name:
            return rule
    raise KeyError(name)


def run_mutation(name: str) -> Report:
    """Run one rule over its seeded-violation fixture. The report MUST
    carry findings attributed to the rule: asserted by the self-test."""
    ctx = MUTATIONS[name]()
    return run_rules([rule_by_name(name)], ctx)
