"""Static correctness plane: contract engine + rule packs, ported from
:mod:`crosscoder_tpu.analysis.contracts`.

Four rule families, each a pure function of a prebuilt context:

- ``step_rules``    — the recorded eager step: aten op stream, kernel
  launches, host data, state storage (StepContext; JAX: ``hlo_rules``)
- ``kernel_safety`` — the Hopper kernels' captured launches, ptxas report
  and sanitizers, on the card (KernelContext; JAX: ``pallas_safety``)
- ``ast_lints``     — repo-wide source invariants (SourceContext)
- ``cache_keys``    — the compile tier's library-key completeness
  (CacheKeyContext)

``python -m crosscoder_tpu_torch.analysis.contracts`` is the CLI
(``scripts/analyze.py``'s counterpart); ``mutations`` carries one seeded
violation per rule so the checker itself is checked.
"""

from crosscoder_tpu_torch.analysis.contracts.ast_lints import (AST_RULES, SourceContext,
                                                               build_source_context)
from crosscoder_tpu_torch.analysis.contracts.cache_keys import (CACHE_RULES, CacheKeyContext,
                                                                build_cache_key_context)
from crosscoder_tpu_torch.analysis.contracts.engine import Finding, Report, Rule, run_rules
from crosscoder_tpu_torch.analysis.contracts.kernel_safety import (KERNEL_RULES,
                                                                   KernelContext,
                                                                   launch_table,
                                                                   run_kernel_probes,
                                                                   smem_summary)
from crosscoder_tpu_torch.analysis.contracts.mutations import (ALL_RULES, JAX_RULE, MUTATIONS,
                                                               run_mutation)
from crosscoder_tpu_torch.analysis.contracts.step_rules import (STEP_RULES, StepContext,
                                                                build_step_context,
                                                                record_step)

__all__ = [
    "Finding", "Report", "Rule", "run_rules",
    "STEP_RULES", "StepContext", "build_step_context", "record_step",
    "KERNEL_RULES", "KernelContext", "run_kernel_probes", "smem_summary", "launch_table",
    "AST_RULES", "SourceContext", "build_source_context",
    "CACHE_RULES", "CacheKeyContext", "build_cache_key_context",
    "ALL_RULES", "MUTATIONS", "JAX_RULE", "run_mutation",
]
