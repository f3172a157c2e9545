"""Repo-wide AST invariant lints, ported from
:mod:`crosscoder_tpu.analysis.contracts.ast_lints`.

Six invariants, cheap to state and expensive to discover broken at run
time, checked over the parsed source of ``crosscoder_tpu_torch/`` (plus
``chip_smoke.py`` and the port's scripts under ``scripts/`` for the gate
lint):

- **lint-gate-registry**: every ``CROSSCODER_*_PALLAS`` string literal
  names a known gate. The port has no Pallas fallback to gate (it has no
  ``ops/dispatch.py``: a wrapper launches its kernel on a CUDA tensor or
  raises), so its gate set is empty and any such literal is a finding: an
  env var no code reads, a silent no-op.
- **lint-cfg-fields**: every ``cfg.<attr>`` read resolves on a known
  config surface (the port's ``config.known_attrs()`` ∪ its
  ``models/lm.py`` ``LMConfig``), and every *dataclass field* actually read
  is mentioned somewhere in ``docs/*.md`` or ``README.md``.
- **lint-no-stdout-print**: no bare ``print`` (without ``file=``) in
  library code: stdout belongs to the one-JSON-line contract of the
  entry points; diagnostics go to stderr. A deliberate one-line report or
  handshake carries ``# contracts: allow(lint-no-stdout-print)``.
- **lint-span-taxonomy**: every ``span("<literal>")`` name belongs to the
  documented taxonomy table in ``docs/OBSERVABILITY.md``.
- **lint-metric-keys**: every constant metric key rides one of the JAX
  package's documented namespaces, also through registries bound to
  nonstandard names (``foo = MetricsRegistry()`` → ``foo.gauge(...)``).
- **lint-unused-imports**: a pyflakes-lite unused-import pass.

The rules, their messages and their findings are the JAX package's, but
for the gate lint's message (the port has no dispatch module). A context
names the package whose files are library code (``package``), so the
rules run over the JAX package's tree as they do over the port's.

Single-line suppression: append ``# contracts: allow(<rule-name>)`` to
the flagged line (see :func:`engine.line_suppresses`).
"""

from __future__ import annotations

import ast
import dataclasses
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

from crosscoder_tpu_torch.analysis.contracts.engine import (Finding, Rule,
                                                            line_suppresses)

PACKAGE = "crosscoder_tpu_torch"
GATE_RE = re.compile(r"^CROSSCODER_[A-Z0-9_]+_PALLAS$")
# the port's gates: none (no fallback to gate)
KNOWN_GATES: frozenset[str] = frozenset()

# metric-key surface: the JAX package's namespaces and keys
NAMESPACES = ("resilience/", "perf/", "comm/", "harvest/", "tenant/",
              "serve/", "tune/", "compile/")
REFERENCE_KEYS = {
    "loss", "l2_loss", "l1_loss", "l0_loss", "l1_coeff", "lr",
    "explained_variance",
}
_EV_TAG = re.compile(r"^explained_variance_[A-H0-9]\d*$")
EXTENSION_KEYS = {
    "dead_frac", "aux_loss", "resampled", "step_time_ms",
    "explained_variance_per_source",
}
REGISTRY_METHODS = {"count", "gauge", "ema", "observe"}
METRIC_DICT_NAMES = {"metrics", "scalars"}
REGISTRY_RECEIVERS = {"registry", "reg", "r"}


def key_allowed(key: str) -> bool:
    if any(key.startswith(ns) and len(key) > len(ns) for ns in NAMESPACES):
        return True
    return key in REFERENCE_KEYS or key in EXTENSION_KEYS \
        or bool(_EV_TAG.match(key))


@dataclass
class SourceContext:
    """Parsed-source inputs for the AST lints. Pure data: mutation
    self-tests seed violating sources without touching the real tree.
    ``package``: the top-level directory whose files are library code."""

    files: dict[str, str] = field(default_factory=dict)   # relpath -> source
    docs_text: str = ""
    span_taxonomy: frozenset[str] = frozenset()
    known_gates: frozenset[str] = frozenset()
    cfg_attrs: frozenset[str] = frozenset()
    cfg_fields: frozenset[str] = frozenset()   # dataclass fields (doc check)
    package: str = PACKAGE
    _trees: dict[str, ast.AST] = field(default_factory=dict, repr=False)

    def tree(self, path: str) -> ast.AST:
        if path not in self._trees:
            self._trees[path] = ast.parse(self.files[path], filename=path)
        return self._trees[path]

    def library_files(self):
        return [p for p in sorted(self.files) if p.startswith(f"{self.package}/")]

    def source_line(self, path: str, lineno: int) -> str:
        lines = self.files[path].splitlines()
        return lines[lineno - 1] if 0 < lineno <= len(lines) else ""


def port_scripts(root: Path) -> list[Path]:
    """The scripts under ``scripts/`` that drive the port (they import
    ``crosscoder_tpu_torch``), and ``chip_smoke.py``."""
    out = [p for p in sorted((root / "scripts").glob("*.py"))
           if PACKAGE in p.read_text()]
    smoke = root / "chip_smoke.py"
    return out + ([smoke] if smoke.is_file() else [])


def build_source_context(root: str | Path | None = None) -> SourceContext:
    """Context over the port's real tree: every ``.py`` of the package,
    the port's scripts and ``chip_smoke.py``, ``docs/*.md`` + ``README.md``,
    the span table of ``docs/OBSERVABILITY.md`` and the port's config
    surfaces."""
    root = Path(root) if root else Path(__file__).resolve().parents[3]
    ctx = SourceContext()
    for p in sorted((root / PACKAGE).rglob("*.py")) + port_scripts(root):
        ctx.files[str(p.relative_to(root))] = p.read_text()
    docs = []
    for p in sorted((root / "docs").glob("*.md")):
        docs.append(p.read_text())
    readme = root / "README.md"
    if readme.exists():
        docs.append(readme.read_text())
    ctx.docs_text = "\n".join(docs)
    obs_md = root / "docs" / "OBSERVABILITY.md"
    ctx.span_taxonomy = frozenset(parse_span_taxonomy(
        obs_md.read_text() if obs_md.exists() else ""))
    ctx.known_gates = KNOWN_GATES

    from crosscoder_tpu_torch import config as config_mod
    from crosscoder_tpu_torch.models import lm
    attrs = set(config_mod.known_attrs())
    attrs |= {f.name for f in dataclasses.fields(lm.LMConfig)}
    attrs |= {n for n in vars(lm.LMConfig) if not n.startswith("_")}
    ctx.cfg_attrs = frozenset(attrs)
    ctx.cfg_fields = frozenset(
        f.name for f in dataclasses.fields(config_mod.CrossCoderConfig))
    return ctx


def parse_span_taxonomy(observability_md: str) -> set[str]:
    """Span names from the ``| `name` | thread | brackets |`` table rows
    of docs/OBSERVABILITY.md."""
    names = set()
    for line in observability_md.splitlines():
        m = re.match(r"\|\s*`([a-z_]+)`\s*\|", line)
        if m:
            names.add(m.group(1))
    return names


def _is_src_ctx(ctx: Any) -> bool:
    return isinstance(ctx, SourceContext) and bool(ctx.files)


def _suppressed(ctx: SourceContext, path: str, lineno: int,
                rule: str) -> bool:
    return line_suppresses(ctx.source_line(path, lineno), rule)


# ---------------------------------------------------------------------------
# gate registry


def _check_gates(ctx: SourceContext) -> list[Finding]:
    out = []
    for path in sorted(ctx.files):
        for node in ast.walk(ctx.tree(path)):
            if (isinstance(node, ast.Constant)
                    and isinstance(node.value, str)
                    and GATE_RE.match(node.value)
                    and node.value not in ctx.known_gates
                    and not _suppressed(ctx, path, node.lineno,
                                        "lint-gate-registry")):
                out.append(Finding(
                    rule="lint-gate-registry",
                    location=f"{path}:{node.lineno}",
                    message=f"gate string {node.value!r} names no known "
                            f"gate — no kernel reads it (the port has no "
                            f"fallback to gate), so setting it is a "
                            f"silent no-op",
                ))
    return out


# ---------------------------------------------------------------------------
# cfg fields


def _check_cfg_fields(ctx: SourceContext) -> list[Finding]:
    out = []
    fields_read: set[str] = set()
    for path in ctx.library_files():
        for node in ast.walk(ctx.tree(path)):
            if (isinstance(node, ast.Attribute)
                    and isinstance(node.value, ast.Name)
                    and node.value.id == "cfg"
                    and not node.attr.startswith("_")):
                if node.attr in ctx.cfg_fields:
                    fields_read.add(node.attr)
                if node.attr not in ctx.cfg_attrs and not _suppressed(
                        ctx, path, node.lineno, "lint-cfg-fields"):
                    out.append(Finding(
                        rule="lint-cfg-fields",
                        location=f"{path}:{node.lineno}",
                        message=f"cfg.{node.attr} does not exist on any "
                                f"known config class (typo, or a field "
                                f"missing from config.py)",
                    ))
    for name in sorted(fields_read):
        if not re.search(rf"\b{re.escape(name)}\b", ctx.docs_text):
            out.append(Finding(
                rule="lint-cfg-fields", location=f"config.py:{name}",
                message=f"config field {name!r} is read by library code "
                        f"but mentioned nowhere in docs/ (add it to the "
                        f"config index in docs/ANALYSIS.md)",
            ))
    return out


# ---------------------------------------------------------------------------
# stdout print


def _check_stdout_print(ctx: SourceContext) -> list[Finding]:
    out = []
    for path in ctx.library_files():
        for node in ast.walk(ctx.tree(path)):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "print"
                    and not any(kw.arg == "file" for kw in node.keywords)
                    and not _suppressed(ctx, path, node.lineno,
                                        "lint-no-stdout-print")):
                out.append(Finding(
                    rule="lint-no-stdout-print",
                    location=f"{path}:{node.lineno}",
                    message="bare print writes to stdout, which belongs "
                            "to the bench one-JSON-line contract — pass "
                            "file=sys.stderr",
                ))
    return out


# ---------------------------------------------------------------------------
# span taxonomy


def _check_spans(ctx: SourceContext) -> list[Finding]:
    out = []
    for path in ctx.library_files():
        if path.endswith("obs/trace.py"):
            continue                         # the tracer defines span()
        for node in ast.walk(ctx.tree(path)):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            is_span = (isinstance(fn, ast.Attribute) and fn.attr == "span") \
                or (isinstance(fn, ast.Name) and fn.id == "span")
            if (is_span and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)
                    and node.args[0].value not in ctx.span_taxonomy
                    and not _suppressed(ctx, path, node.lineno,
                                        "lint-span-taxonomy")):
                out.append(Finding(
                    rule="lint-span-taxonomy",
                    location=f"{path}:{node.lineno}",
                    message=f"span {node.args[0].value!r} is not in the "
                            f"docs/OBSERVABILITY.md taxonomy table — "
                            f"trace_report and bubble attribution will "
                            f"not see it",
                ))
    return out


# ---------------------------------------------------------------------------
# metric keys


def _receiver_tail(node: ast.expr) -> str | None:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def registry_bindings(tree: ast.AST) -> set[str]:
    """Names bound to ``MetricsRegistry()`` in this module (``foo = ...``
    and ``self.foo = ...``)."""
    bound = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Call)):
            callee = node.value.func
            name = callee.attr if isinstance(callee, ast.Attribute) \
                else getattr(callee, "id", None)
            if name == "MetricsRegistry":
                for tgt in node.targets:
                    tail = _receiver_tail(tgt)
                    if tail:
                        bound.add(tail)
    return bound


def collect_keys(tree: ast.AST) -> list[tuple[int, str]]:
    """(lineno, key) for every string-constant metric key in the module:
    registry method calls (standard receivers + module-local
    ``MetricsRegistry()`` bindings) and metric-dict stores."""
    receivers = REGISTRY_RECEIVERS | registry_bindings(tree)
    found: list[tuple[int, str]] = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in REGISTRY_METHODS
                and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)
                and _receiver_tail(node.func.value) in receivers):
            found.append((node.lineno, node.args[0].value))
        elif isinstance(node, ast.Assign):
            for tgt in node.targets:
                if (isinstance(tgt, ast.Subscript)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id in METRIC_DICT_NAMES
                        and isinstance(tgt.slice, ast.Constant)
                        and isinstance(tgt.slice.value, str)):
                    found.append((tgt.lineno, tgt.slice.value))
            if (len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and node.targets[0].id in METRIC_DICT_NAMES
                    and isinstance(node.value, ast.Dict)):
                for k in node.value.keys:
                    if isinstance(k, ast.Constant) and isinstance(k.value, str):
                        found.append((k.lineno, k.value))
    return found


def _check_metric_keys(ctx: SourceContext) -> list[Finding]:
    out = []
    for path in ctx.library_files():
        for lineno, key in collect_keys(ctx.tree(path)):
            if not key_allowed(key) and not _suppressed(
                    ctx, path, lineno, "lint-metric-keys"):
                out.append(Finding(
                    rule="lint-metric-keys",
                    location=f"{path}:{lineno}",
                    message=f"metric key {key!r} outside the documented "
                            f"namespace (reference 9-key | "
                            f"{' | '.join(NAMESPACES)} | documented "
                            f"extensions)",
                ))
    return out


# ---------------------------------------------------------------------------
# unused imports


def _check_unused_imports(ctx: SourceContext) -> list[Finding]:
    out = []
    for path in ctx.library_files():
        if path.endswith("__init__.py"):
            continue                         # re-export surface
        tree = ctx.tree(path)
        imported: dict[str, int] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    imported[a.asname or a.name.split(".")[0]] = node.lineno
            elif isinstance(node, ast.ImportFrom):
                if node.module == "__future__":
                    continue
                for a in node.names:
                    if a.name == "*":
                        continue
                    imported[a.asname or a.name] = node.lineno
        if not imported:
            continue
        used: set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Name):
                used.add(node.id)
            elif isinstance(node, ast.Constant) and isinstance(node.value, str):
                used.add(node.value)         # __all__ entries, doc refs
        for name, lineno in sorted(imported.items()):
            if name not in used and not _suppressed(
                    ctx, path, lineno, "lint-unused-imports"):
                out.append(Finding(
                    rule="lint-unused-imports",
                    location=f"{path}:{lineno}",
                    message=f"import {name!r} is never used in the module",
                ))
    return out


AST_RULES: list[Rule] = [
    Rule("lint-gate-registry",
         "every CROSSCODER_*_PALLAS literal names a known dispatch gate",
         _is_src_ctx, _check_gates),
    Rule("lint-cfg-fields",
         "every cfg.* read exists on a config class and is documented",
         _is_src_ctx, _check_cfg_fields),
    Rule("lint-no-stdout-print",
         "library code never prints to stdout (bench contract)",
         _is_src_ctx, _check_stdout_print),
    Rule("lint-span-taxonomy",
         "every literal span name is in the documented taxonomy",
         _is_src_ctx, _check_spans),
    Rule("lint-metric-keys",
         "every constant metric key rides a documented namespace",
         _is_src_ctx, _check_metric_keys),
    Rule("lint-unused-imports",
         "no module imports a name it never uses",
         _is_src_ctx, _check_unused_imports),
]
