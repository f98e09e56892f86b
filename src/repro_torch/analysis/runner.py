"""Rule registry, file discovery, pragma filtering and the baseline:
the port's counterpart of ``repro.analysis.runner``.

  1. discover the ``.py`` files under the configured paths (fixture
     corpora excluded) and parse each once into a :class:`Project`;
  2. run each enabled rule;
  3. drop the findings an inline ``# repro-lint: allow[rule] reason``
     pragma suppresses (the reason is required);
  4. split the rest against the committed baseline: baselined
     fingerprints are reported apart and do not fail the run, new
     findings do; under ``--strict`` a baseline entry that matches
     nothing fails too, so fixed debt leaves the baseline in its diff.
"""
from __future__ import annotations

import ast
import json
import os
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from repro_torch.analysis.base import ParsedFile, Project, Violation
from repro_torch.analysis.catalog import check_metric_catalog
from repro_torch.analysis.enums import check_enum_append
from repro_torch.analysis.lifecycle import check_state_exhaustive
from repro_torch.analysis.purity import check_dispatch_purity, \
    check_wallclock
from repro_torch.analysis.rng import check_rng_discipline

ALL_RULES = ("dispatch-purity", "rng-discipline", "state-exhaustive",
             "enum-append", "metric-catalog", "wallclock")

_PKG = "src/repro_torch"
BASELINE = f"{_PKG}/analysis/lint_baseline.json"


@dataclass
class LintConfig:
    root: str
    paths: Tuple[str, ...] = (_PKG, "chip_smoke.py", "chip_seeds.py",
                              "chip_ab.py")
    exclude: Tuple[str, ...] = ("tests/fixtures/lint",)
    rules: Tuple[str, ...] = ALL_RULES
    # per-rule scopes (repository-relative)
    rng_scope: Tuple[str, ...] = (f"{_PKG}/serve",)
    rng_global_scope: Tuple[str, ...] = (f"{_PKG}/serve", f"{_PKG}/train",
                                         f"{_PKG}/core", f"{_PKG}/models")
    wallclock_scope: Tuple[str, ...] = (f"{_PKG}/obs", f"{_PKG}/serve")
    lifecycle_files: Tuple[str, ...] = (f"{_PKG}/serve/scheduler.py",
                                        f"{_PKG}/serve/recovery.py")
    state_module: str = f"{_PKG}/serve/scheduler.py"
    metric_scope: Tuple[str, ...] = (f"{_PKG}/serve", f"{_PKG}/obs")
    # (file, section heading or "" for the whole file)
    metric_docs: Tuple[Tuple[str, str], ...] = (
        ("docs/observability.md", ""),
        ("README.md", "Metrics only the port emits"))
    enum_manifest: str = f"{_PKG}/analysis/enum_manifest.json"
    # the model's step entry points and the kernel wrappers
    purity_roots: Tuple[str, ...] = (
        f"{_PKG}/models/model.py::Model.mixed_step",
        f"{_PKG}/models/model.py::Model.prefill",
        f"{_PKG}/models/model.py::Model.decode_step",
        f"{_PKG}/models/model.py::Model.logits",
        f"{_PKG}/kernels/ops.py::*")


@dataclass
class LintResult:
    violations: List[Violation] = field(default_factory=list)   # failing
    suppressed: List[Tuple[Violation, str]] = field(default_factory=list)
    baselined: List[Violation] = field(default_factory=list)
    stale_baseline: List[str] = field(default_factory=list)
    parse_errors: List[Violation] = field(default_factory=list)

    def failed(self, strict: bool) -> bool:
        if self.violations or self.parse_errors:
            return True
        return strict and bool(self.stale_baseline)


def _discover(cfg: LintConfig) -> Tuple[Project, List[Violation]]:
    project = Project(root=cfg.root)
    errors: List[Violation] = []
    for prefix in cfg.paths:
        top = os.path.join(cfg.root, prefix)
        if os.path.isfile(top) and top.endswith(".py"):
            candidates = [top]
        else:
            candidates = []
            for dirpath, dirnames, filenames in os.walk(top):
                dirnames[:] = sorted(
                    d for d in dirnames
                    if d not in {"__pycache__", ".git", ".pytest_cache"})
                candidates += [os.path.join(dirpath, fn)
                               for fn in sorted(filenames)
                               if fn.endswith(".py")]
        for path in candidates:
            rel = os.path.relpath(path, cfg.root).replace(os.sep, "/")
            if any(rel == e or rel.startswith(e.rstrip("/") + "/")
                   for e in cfg.exclude):
                continue
            with open(path, "r", encoding="utf-8") as fh:
                source = fh.read()
            try:
                tree = ast.parse(source, filename=rel)
            except SyntaxError as exc:
                errors.append(Violation(rel, exc.lineno or 1, "parse",
                                        f"syntax error: {exc.msg}"))
                continue
            project.files[rel] = ParsedFile(rel, source, tree)
    return project, errors


def _run_rules(project: Project, cfg: LintConfig) -> List[Violation]:
    out: List[Violation] = []
    if "dispatch-purity" in cfg.rules:
        out.extend(check_dispatch_purity(project, cfg.purity_roots))
    if "rng-discipline" in cfg.rules:
        out.extend(check_rng_discipline(project, cfg.rng_scope,
                                        cfg.rng_global_scope))
    if "state-exhaustive" in cfg.rules:
        out.extend(check_state_exhaustive(
            project, cfg.lifecycle_files, cfg.state_module))
    if "enum-append" in cfg.rules:
        out.extend(check_enum_append(project, cfg.enum_manifest))
    if "metric-catalog" in cfg.rules:
        out.extend(check_metric_catalog(project, cfg.metric_scope,
                                        cfg.metric_docs))
    if "wallclock" in cfg.rules:
        out.extend(check_wallclock(project, cfg.wallclock_scope))
    return sorted(set(out))


def load_baseline(path: str) -> List[str]:
    try:
        with open(path, "r", encoding="utf-8") as fh:
            data = json.load(fh)
    except OSError:
        return []
    return list(data.get("allow", []))


def write_baseline(path: str, violations: List[Violation]) -> None:
    data = {
        "_comment": "repro-lint allowlist of the port: line-free "
                    "fingerprints of accepted findings. Regenerate with "
                    "python -m repro_torch.analysis --write-baseline; "
                    "--strict fails on entries that match nothing.",
        "allow": sorted({v.fingerprint for v in violations}),
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(data, fh, indent=2)
        fh.write("\n")


def run_lint(cfg: LintConfig, baseline: Optional[List[str]] = None
             ) -> LintResult:
    project, errors = _discover(cfg)
    result = LintResult(parse_errors=errors)
    unsuppressed: List[Violation] = []
    for v in _run_rules(project, cfg):
        f = project.get(v.path)
        pragma = f.pragma_for(v.line, v.rule) if f is not None else None
        if pragma is not None:
            result.suppressed.append((v, pragma.reason))
        else:
            unsuppressed.append(v)

    allow = set(baseline or [])
    matched: set = set()
    for v in unsuppressed:
        if v.fingerprint in allow:
            result.baselined.append(v)
            matched.add(v.fingerprint)
        else:
            result.violations.append(v)
    result.stale_baseline = sorted(allow - matched)
    return result
