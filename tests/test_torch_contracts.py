"""The port's static correctness plane (crosscoder_tpu_torch/analysis/
contracts/) against the JAX package's (crosscoder_tpu/analysis/contracts/)
on the CPU:

- the engine: the same rules and findings give byte-equal ``to_json()``
  and ``format_human()`` in both packages, with the same crash, allow and
  skip behaviour, and the same suppression comments;
- the AST lints: JAX's lint mutation fixtures and JAX's real source
  context give the same findings through both rule sets; the port's lints
  are clean on the port's tree;
- the cache keys: the port's ``cache-key-completeness`` over JAX's context
  and JAX's leaky-digest fixture gives JAX's findings, and is clean on the
  port's real library keys; the refactored hash and key code give the
  names and digests the old code gave; ``STEP_FIELDS`` is JAX's;
- the mutations: every port rule has one and it fires; ``ALL_RULES`` maps
  one to one onto JAX's 27;
- the CLI: ``--json`` prints exactly one document, ``--mutate`` exits
  nonzero, ``--list`` names every rule, the default device asks for the
  card.
"""

import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from crosscoder_tpu.analysis.contracts import ast_lints as jlints
from crosscoder_tpu.analysis.contracts import cache_keys as jkeys
from crosscoder_tpu.analysis.contracts import engine as jengine
from crosscoder_tpu.analysis.contracts import mutations as jmut
from crosscoder_tpu.config import known_attrs as jknown_attrs
from crosscoder_tpu.tune import lattice as jlattice
from crosscoder_tpu_torch import config
from crosscoder_tpu_torch.analysis.contracts import (ALL_RULES, AST_RULES, CACHE_RULES,
                                                     JAX_RULE, MUTATIONS, ast_lints,
                                                     build_cache_key_context,
                                                     build_source_context, cache_keys, engine,
                                                     run_mutation, run_rules)
from crosscoder_tpu_torch.ops import _build
from crosscoder_tpu_torch.tune import lattice
from crosscoder_tpu_torch.utils import compile_cache

ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# the engine


def _rules(pkg):
    """The same four rules in ``pkg``'s engine: findings (an error and a
    warning with and without a location), a crash, an inapplicable rule,
    a rule to allow."""
    F, R = pkg.Finding, pkg.Rule
    return [
        R("finds", "two findings", lambda c: True,
          lambda c: [F(rule="finds", message="bad thing", location="a.py:3"),
                     F(rule="finds", message="mild", severity="warning")]),
        R("boom", "always crashes", lambda c: True, lambda c: 1 / 0),
        R("never", "not applicable", lambda c: False, lambda c: []),
        R("noisy", "to allow", lambda c: True, lambda c: [F(rule="noisy", message="x")]),
    ]


@pytest.mark.parametrize("allow", [frozenset(), frozenset({"noisy"}), frozenset({"finds",
                                                                                  "boom"})])
def test_engine_reports_are_byte_equal_to_jaxs(allow):
    got = engine.run_rules(_rules(engine), None, allow)
    want = jengine.run_rules(_rules(jengine), None, allow)
    for rep in (got, want):
        rep.info["smem/x"] = "1.0 KiB"
    assert got.to_json() == want.to_json()
    assert got.format_human() == want.format_human()
    assert (got.ok, got.checked, got.skipped, got.suppressed) == (
        want.ok, want.checked, want.skipped, want.suppressed)


def test_engine_merge_and_crash_as_jaxs():
    a = engine.run_rules(_rules(engine)[:2], None).merge(
        engine.run_rules(_rules(engine)[2:], None))
    b = jengine.run_rules(_rules(jengine)[:2], None).merge(
        jengine.run_rules(_rules(jengine)[2:], None))
    assert a.to_json() == b.to_json()
    crash = [f for f in a.findings if f.rule == "boom"]
    assert not a.ok and crash and "harness crashed: ZeroDivisionError" in crash[0].message


@pytest.mark.parametrize("line", [
    "x = 1  # contracts: allow(lint-no-stdout-print)",
    "print(  # contracts: allow(lint-no-stdout-print, lint-metric-keys) — one-line report",
    "x = 1  #contracts:allow( lint-metric-keys )",
    "x = 1  # contracts: allow(other-rule)",
    "x = 1",
])
def test_suppression_comments_as_jaxs(line):
    for rule in ("lint-no-stdout-print", "lint-metric-keys"):
        assert engine.line_suppresses(line, rule) == jengine.line_suppresses(line, rule)
    assert engine.SUPPRESS_RE.pattern == jengine.SUPPRESS_RE.pattern


# ---------------------------------------------------------------------------
# the AST lints


def _as_port(jctx) -> ast_lints.SourceContext:
    return ast_lints.SourceContext(
        files=jctx.files, docs_text=jctx.docs_text, span_taxonomy=jctx.span_taxonomy,
        known_gates=jctx.known_gates, cfg_attrs=jctx.cfg_attrs, cfg_fields=jctx.cfg_fields,
        package="crosscoder_tpu")


def _key(f, with_message: bool):
    return (f.rule, f.location, f.severity) + ((f.message,) if with_message else ())


def _same_findings(got, want):
    # the gate lint's message names the port's (empty) gate set, not dispatch
    assert [_key(f, f.rule != "lint-gate-registry") for f in got.findings] == \
        [_key(f, f.rule != "lint-gate-registry") for f in want.findings]
    assert (got.checked, got.skipped) == (want.checked, want.skipped)


JAX_LINT_FIXTURES = ["lint-gate-registry", "lint-cfg-fields", "lint-no-stdout-print",
                     "lint-span-taxonomy", "lint-metric-keys", "lint-unused-imports"]


@pytest.mark.parametrize("rule", JAX_LINT_FIXTURES)
def test_lints_on_jaxs_mutation_fixtures_give_jaxs_findings(rule):
    jctx = jmut.MUTATIONS[rule]()
    want = jengine.run_rules(jlints.AST_RULES, jctx)
    got = run_rules(AST_RULES, _as_port(jctx))
    assert any(f.rule == rule for f in want.findings)
    _same_findings(got, want)


@pytest.fixture(scope="module")
def jax_source_ctx():
    return jlints.build_source_context()


def test_lints_on_jaxs_tree_give_jaxs_findings(jax_source_ctx):
    _same_findings(run_rules(AST_RULES, _as_port(jax_source_ctx)),
                   jengine.run_rules(jlints.AST_RULES, jax_source_ctx))


@pytest.mark.parametrize("rule", JAX_LINT_FIXTURES)
def test_each_lint_on_jaxs_tree_gives_jaxs_findings(jax_source_ctx, rule):
    port = [r for r in AST_RULES if r.name == rule]
    jax = [r for r in jlints.AST_RULES if r.name == rule]
    _same_findings(run_rules(port, _as_port(jax_source_ctx)),
                   jengine.run_rules(jax, jax_source_ctx))


@pytest.fixture(scope="module")
def port_source_ctx():
    return build_source_context()


def test_port_lints_clean_on_the_port_tree(port_source_ctx):
    rep = run_rules(AST_RULES, port_source_ctx)
    assert rep.ok and not rep.findings, "\n".join(str(f) for f in rep.findings)
    assert len(rep.checked) == len(AST_RULES)


def test_port_source_context_reads_the_port(port_source_ctx):
    files = set(port_source_ctx.files)
    assert "crosscoder_tpu_torch/analysis/contracts/ast_lints.py" in files
    assert {"chip_smoke.py", "scripts/torch_kernel_variants.py"} <= files
    assert not any(p.startswith("crosscoder_tpu/") for p in files)
    assert "scripts/analyze.py" not in files            # the JAX package's CLI
    assert port_source_ctx.known_gates == frozenset()
    assert {"step", "compile", "prefill"} <= port_source_ctx.span_taxonomy
    assert "check_buffer" in port_source_ctx.cfg_attrs


def test_known_attrs_covers_jaxs_fields_and_the_ports_methods():
    port = config.known_attrs()
    fields = {f for f in jknown_attrs() if f in JCfgFields()}
    assert fields <= port
    assert {"check_buffer", "n_sources", "replace", "to_dict"} <= port
    assert not any(n.startswith("_") for n in port)


def JCfgFields():
    import dataclasses

    from crosscoder_tpu.config import CrossCoderConfig

    return {f.name for f in dataclasses.fields(CrossCoderConfig)}


def test_gate_lint_flags_any_pallas_gate_in_the_port():
    ctx = ast_lints.SourceContext(files={
        "crosscoder_tpu_torch/x.py": 'A = "CROSSCODER_FUSED_TOPK_PALLAS"\n',
        "chip_smoke.py": 'B = "CROSSCODER_PALLAS"\n',
        "scripts/x.py": 'C = "CROSSCODER_QUANT_PALLAS"  # contracts: allow(lint-gate-registry)\n'})
    got = run_rules([AST_RULES[0]], ctx)
    assert [f.location for f in got.findings] == ["crosscoder_tpu_torch/x.py:1"]


def test_metric_key_lint_tracks_registry_bindings():
    import ast

    tree = ast.parse("m = MetricsRegistry()\nm.observe('rogue_histogram_key', 1.0)\n"
                     "m.gauge('perf/fine', 2.0)\n")
    keys = {k for _, k in ast_lints.collect_keys(tree)}
    assert keys == {k for _, k in jlints.collect_keys(tree)} == {"rogue_histogram_key",
                                                                 "perf/fine"}


# ---------------------------------------------------------------------------
# the cache keys


def _as_port_keys(jctx) -> cache_keys.CacheKeyContext:
    return cache_keys.CacheKeyContext(fields=jctx.fields, base_cfg=jctx.base_cfg,
                                      digest_fn=jctx.digest_fn)


@pytest.mark.parametrize("which", ["real", "leaky"])
def test_cache_key_rule_over_jaxs_contexts_gives_jaxs_findings(which):
    jctx = jkeys.build_cache_key_context() if which == "real" else jmut._mut_cache_key()
    want = jengine.run_rules(jkeys.CACHE_RULES, jctx)
    got = run_rules(CACHE_RULES, _as_port_keys(jctx))
    assert [_key(f, False) for f in got.findings] == [_key(f, False) for f in want.findings]
    assert bool(want.findings) == (which == "leaky")


def test_cache_key_rule_flags_drift_as_jax_does():
    j = jkeys.CacheKeyContext(fields=frozenset({"a", "gone"}), base_cfg={"a": 1},
                              digest_fn=lambda d: repr(sorted(d.items())))
    want = jengine.run_rules(jkeys.CACHE_RULES, j)
    got = run_rules(CACHE_RULES, _as_port_keys(j))
    assert [_key(f, False) for f in got.findings] == [_key(f, False) for f in want.findings] \
        == [("cache-key-completeness", "gone", "error")]


@pytest.fixture(scope="module")
def key_ctx():
    return build_cache_key_context()


def test_cache_key_rule_clean_on_the_ports_library_keys(key_ctx):
    rep = run_rules(CACHE_RULES, key_ctx)
    assert rep.ok and not rep.findings, rep.findings
    names = _build.kernel_names()
    headers = [p.name for p in _build.header_paths()]
    per_lib = 1 + len(headers) + len(_build.NVCC_FLAGS) + 1 + 5
    assert len(key_ctx.fields) == len(names) * per_lib
    for n in names:
        assert {f"{n}/source:{n}.cu", f"{n}/format", f"{n}/fingerprint:nvcc",
                f"{n}/fingerprint:capability"} <= key_ctx.fields


def test_cache_key_surface_runs_the_real_key_code(key_ctx):
    want = ";".join(f"{n}={compile_cache.disk_key(_build._key(n))}"
                    for n in _build.kernel_names())
    assert key_ctx.digest_fn(dict(key_ctx.base_cfg)) == want


def test_a_missing_header_is_drift(key_ctx):
    base = dict(key_ctx.base_cfg)
    gone = sorted(k for k in base if "/header:" in k)[0]
    del base[gone]
    rep = run_rules(CACHE_RULES, cache_keys.CacheKeyContext(
        fields=key_ctx.fields, base_cfg=base, digest_fn=key_ctx.digest_fn))
    assert [f.location for f in rep.findings] == [gone]


@pytest.mark.parametrize("name", _build.kernel_names())
def test_library_hash_keeps_every_librarys_name(name):
    src = (_build.CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(_build.CSRC.glob("*.cuh")))
    old = hashlib.sha256(src + headers + " ".join(_build.NVCC_FLAGS).encode()).hexdigest()
    assert _build.source_hash(name) == old
    assert _build._lib_path(name).name == f"{name}-{old[:16]}.so"


def test_disk_key_and_fingerprint_are_the_old_formulas():
    import torch

    fp = compile_cache.backend_fingerprint()
    assert fp == (f"torch={torch.__version__},cuda={torch.version.cuda},"
                  f"nvcc={_build.nvcc_version()},device=none")
    key = ("topk_mask", _build.source_hash("topk_mask"))
    blob = f"v{compile_cache.DISK_FORMAT}\x1f{fp}\x1f{compile_cache._canon(key)}"
    assert compile_cache.disk_key(key) == hashlib.sha256(blob.encode()).hexdigest()
    parts = dict(compile_cache.fingerprint_parts(), device="NVIDIA H100 80GB HBM3",
                 capability="sm_90")
    assert compile_cache.fingerprint_of(parts).endswith(",device=NVIDIA H100 80GB HBM3,sm_90")


def test_step_fields_are_jaxs():
    assert lattice.STEP_FIELDS == jlattice.STEP_FIELDS


# ---------------------------------------------------------------------------
# mutations


def test_every_rule_has_a_mutation():
    assert {r.name for r in ALL_RULES} == set(MUTATIONS)
    assert len(ALL_RULES) == len(MUTATIONS) == 27


def test_all_rules_map_one_to_one_onto_jaxs():
    assert set(JAX_RULE) == {r.name for r in ALL_RULES}
    assert sorted(JAX_RULE.values()) == sorted(r.name for r in jmut.ALL_RULES)


@pytest.mark.parametrize("rule_name", sorted(MUTATIONS))
def test_mutation_fires(rule_name):
    rep = run_mutation(rule_name)
    fired = [f for f in rep.findings if f.rule == rule_name]
    assert fired, f"seeded violation for {rule_name} produced no finding"
    rule = next(r for r in ALL_RULES if r.name == rule_name)
    if rule_name == "kernel-local-memory":          # spills cost time: a warning
        assert all(f.severity == "warning" for f in fired) and rep.ok
    else:
        assert all(f.severity == "error" for f in fired) and not rep.ok
    assert rep.checked == [rule.name]


# ---------------------------------------------------------------------------
# the CLI


def _cli(*args, env=None):
    return subprocess.run([sys.executable, "-m", "crosscoder_tpu_torch.analysis.contracts",
                           *args], capture_output=True, text=True, cwd=ROOT, timeout=600,
                          env=env)


def test_cli_on_the_cpu_prints_one_json_document_and_passes():
    p = _cli("--device", "cpu", "--json")
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    doc = json.loads(p.stdout)                 # a second document would raise
    assert doc["ok"] is True and doc["findings"] == []
    assert set(doc) == {"ok", "findings", "checked", "skipped", "suppressed", "info"}
    skipped = {r.name for r in ALL_RULES if r.name.startswith("kernel-")} | {
        "step-fused-no-dense-preacts", "step-serve-no-dense-preacts"}
    assert set(doc["skipped"]) == skipped
    assert set(doc["checked"]) == {r.name for r in ALL_RULES} - skipped
    assert all(doc["info"][f"skipped/{r}"] for r in skipped)


def test_cli_allow_records_a_suppressed_rule():
    p = _cli("--device", "cpu", "--json", "--skip-steps", "--skip-kernels",
             "--allow", "lint-unused-imports,lint-span-taxonomy")
    doc = json.loads(p.stdout)
    assert p.returncode == 0 and sorted(doc["suppressed"]) == ["lint-span-taxonomy",
                                                               "lint-unused-imports"]


@pytest.mark.parametrize("rule", ["lint-no-stdout-print", "step-donation-honored",
                                  "kernel-local-memory"])
def test_cli_mutate_exits_nonzero(rule):
    p = _cli("--mutate", rule, "--json")
    assert p.returncode == 1, p.stderr
    doc = json.loads(p.stdout)
    assert doc["findings"][0]["rule"] == rule


def test_cli_list_names_every_rule():
    p = _cli("--list")
    assert p.returncode == 0
    assert [ln.split()[0] for ln in p.stdout.splitlines()] == [r.name for r in ALL_RULES]


def test_cli_asks_for_the_card_without_a_device():
    p = _cli("--skip-lints", "--json", env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0 and "no CUDA device" in p.stderr and not p.stdout.strip()
