"""The port's repro-lint (``repro_torch.analysis``): every rule fires on
its seeded fixture and stays quiet on its clean twin; pragmas suppress
only with a reason; the baseline admits and goes stale; a parse error is
reported; the port's tree lints clean. Where both packages check the same
rule (state-exhaustive, enum-append, metric-catalog, wallclock, and
rng-discipline's key-draw finding and its scope), the same seeded defect,
written in each package's idiom where the idioms differ, gives the same
findings (rule and line) from both runners.

Fixtures live in tests/fixtures/lint/torch/, which the reference's runner
excludes from its real-tree run and pytest does not collect.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro import analysis as ref
from repro_torch import analysis as port
from repro_torch.analysis.runner import BASELINE

REPO = Path(__file__).resolve().parents[1]
FIX = REPO / "tests" / "fixtures" / "lint" / "torch"


def port_cfg(*paths, **kw):
    """A port LintConfig rooted at the fixture corpus."""
    defaults = dict(
        root=str(FIX), paths=tuple(paths), exclude=(),
        rng_scope=("serve",), rng_global_scope=("models", "serve"),
        wallclock_scope=("cases",), lifecycle_files=tuple(paths),
        state_module=paths[0] if paths else "", metric_scope=("cases",),
        metric_docs=(("docs/catalog_ok.md", ""),),
        enum_manifest="manifests/enum_ok.json",
        purity_roots=("cases/purity_bad.py::Model.mixed_step",
                      "cases/purity_clean.py::Model.mixed_step",
                      "cases/kernels_ops.py::*"))
    defaults.update(kw)
    return port.LintConfig(**defaults)


def ref_cfg(*paths, **kw):
    """The reference's LintConfig on the same corpus and scopes."""
    defaults = dict(
        root=str(FIX), paths=tuple(paths), exclude=(),
        rng_scope=("serve",), wallclock_scope=("cases",),
        lifecycle_files=tuple(paths), state_module=paths[0],
        metric_scope=("cases",), metrics_doc="docs/catalog_ok.md",
        enum_manifest="manifests/enum_ok.json")
    defaults.update(kw)
    return ref.LintConfig(**defaults)


def run_port(rule, *paths, **kw):
    return port.run_lint(port_cfg(*paths, rules=(rule,), **kw))


def found(result):
    return sorted((v.rule, v.path, v.line) for v in result.violations)


# ---------------------------------------------------------------------------
# each rule on its fixture and its clean twin


def test_dispatch_purity_fires():
    r = run_port("dispatch-purity", "cases/purity_bad.py",
                 "cases/kernels_ops.py")
    msgs = [v.message for v in r.violations]
    for what in ("global", "time.perf_counter", "print", "np.random.normal",
                 "torch.rand", ".inc()", "open()"):
        assert any(what in m for m in msgs), what
    # the print two calls below the root names its path from the root
    deep = [v for v in r.violations if "print" in v.message]
    assert len(deep) == 1 and "root cases/purity_bad.py::Model.mixed_step" \
        in deep[0].message and "_norm" in deep[0].message
    # a private function of the wrapper module is no root, and a method
    # no root reaches is not checked
    lines = {(v.path, v.line) for v in r.violations}
    assert ("cases/kernels_ops.py", 11) not in lines
    assert ("cases/purity_bad.py", 31) not in lines


def test_dispatch_purity_names_a_missing_root():
    r = run_port("dispatch-purity", "cases/purity_clean.py",
                 purity_roots=("cases/purity_clean.py::Model.renamed",))
    assert [v.message for v in r.violations] == [
        "purity root cases/purity_clean.py::Model.renamed names no "
        "definition"]


def test_dispatch_purity_clean():
    assert run_port("dispatch-purity", "cases/purity_clean.py").violations \
        == []


def test_rng_discipline_fires_on_stateful_streams_in_serve():
    r = run_port("rng-discipline", "serve/rng_bad.py")
    msgs = sorted(v.message.split(" ")[:3] for v in r.violations)
    assert len(r.violations) == 2, found(r)
    assert any("numpy generator .random()" in v.message
               for v in r.violations)
    assert any("torch draw in the serve path" in v.message
               for v in r.violations), msgs


def test_rng_discipline_fires_on_global_generators():
    r = run_port("rng-discipline", "models/global_rng_bad.py")
    assert [v.line for v in r.violations] == [7, 8, 9, 10]
    msgs = " ".join(v.message for v in r.violations)
    for what in ("torch.manual_seed", "torch.randn", ".uniform_",
                 "np.random.rand"):
        assert what in msgs, what


@pytest.mark.parametrize("path", ["serve/rng_clean.py",
                                  "models/global_rng_clean.py"])
def test_rng_discipline_clean(path):
    assert run_port("rng-discipline", path).violations == []


def test_state_exhaustive_fires():
    msgs = [v.message for v in run_port(
        "state-exhaustive", "cases/lifecycle_bad.py").violations]
    for what in ("ladder", "membership", "mapping", "quarantined"):
        assert any(what in m for m in msgs), what


def test_state_exhaustive_clean():
    assert run_port("state-exhaustive",
                    "cases/lifecycle_clean.py").violations == []


def test_enum_append_fires():
    msgs = [v.message for v in run_port(
        "enum-append", "cases/enum_mod.py",
        enum_manifest="manifests/enum_bad.json").violations]
    assert any("diverges" in m for m in msgs)
    assert any("grew" in m for m in msgs)


def test_enum_append_clean():
    assert run_port("enum-append", "cases/enum_clean_mod.py").violations \
        == []


def test_metric_catalog_fires():
    msgs = [v.message for v in run_port(
        "metric-catalog", "cases/catalog_code.py",
        metric_docs=(("docs/catalog_bad.md", ""),)).violations]
    assert any("fix_undocumented_ms" in m for m in msgs)
    assert any("fix_shed_*_total" in m for m in msgs)
    assert any("fix_removed_total" in m for m in msgs)


def test_metric_catalog_clean():
    assert run_port("metric-catalog", "cases/catalog_code.py").violations \
        == []


def test_metric_catalog_reads_the_ports_own_section():
    """A name only the port emits is documented in a section of the
    port's own; rows outside that section do not count."""
    shared = (("docs/catalog_shared.md", ""),)
    alone = run_port("metric-catalog", "cases/catalog_port.py",
                     metric_docs=shared)
    assert [v.message.split("`")[1] for v in alone.violations] == [
        "fix_port_only_total"]
    both = run_port("metric-catalog", "cases/catalog_port.py",
                    metric_docs=shared + (("docs/port_readme.md",
                                           "Metrics only the port emits"),))
    assert both.violations == []
    whole = run_port("metric-catalog", "cases/catalog_port.py",
                     metric_docs=shared + (("docs/port_readme.md", ""),))
    assert [v.message.split("`")[1] for v in whole.violations] == [
        "fix_elsewhere_total"]


def test_wallclock_fires():
    r = run_port("wallclock", "cases/wallclock_bad.py")
    assert len(r.violations) == 1 and "time.time()" in r.violations[0].message


def test_wallclock_clean():
    assert run_port("wallclock", "cases/wallclock_clean.py").violations == []


# ---------------------------------------------------------------------------
# pragmas, the baseline, parse errors


def test_pragma_suppression():
    r = run_port("wallclock", "cases/pragma_case.py")
    assert len(r.violations) == 1          # the reasonless pragma
    assert len(r.suppressed) == 2
    assert all(reason for _, reason in r.suppressed)


def test_baseline_admits_and_goes_stale():
    cfg = port_cfg("cases/wallclock_bad.py", rules=("wallclock",))
    fp = port.run_lint(cfg).violations[0].fingerprint
    ok = port.run_lint(cfg, baseline=[fp])
    assert ok.violations == [] and len(ok.baselined) == 1
    assert not ok.failed(strict=True)
    stale = port.run_lint(cfg, baseline=[fp, "cases/nope.py:wallclock:gone"])
    assert stale.stale_baseline == ["cases/nope.py:wallclock:gone"]
    assert stale.failed(strict=True) and not stale.failed(strict=False)


def test_parse_error_is_reported(tmp_path):
    (tmp_path / "broken.py").write_text("def broken(:\n", encoding="utf-8")
    r = port.run_lint(port.LintConfig(root=str(tmp_path), paths=(".",),
                                      rules=("wallclock",),
                                      wallclock_scope=(".",)))
    assert [v.rule for v in r.parse_errors] == ["parse"]
    assert r.failed(strict=False)


# ---------------------------------------------------------------------------
# held against the reference's runner


SHARED = {
    "state-exhaustive": ("cases/lifecycle_bad.py", "cases/lifecycle_clean.py"),
    "enum-append": ("cases/enum_mod.py", "cases/enum_clean_mod.py"),
    "metric-catalog": ("cases/catalog_code.py", "cases/catalog_code.py"),
    "wallclock": ("cases/wallclock_bad.py", "cases/wallclock_clean.py"),
}


@pytest.mark.parametrize("rule", sorted(SHARED))
@pytest.mark.parametrize("case", ["seeded", "clean"])
def test_shared_rules_match_the_reference(rule, case):
    """The same fixture through both runners: the same (rule, file, line)
    findings, and at least one on the seeded case."""
    path = SHARED[rule][case == "clean"]
    kw_ref, kw_port = {}, {}
    if case == "seeded" and rule == "enum-append":
        kw_ref = kw_port = {"enum_manifest": "manifests/enum_bad.json"}
    if case == "seeded" and rule == "metric-catalog":
        kw_ref = {"metrics_doc": "docs/catalog_bad.md"}
        kw_port = {"metric_docs": (("docs/catalog_bad.md", ""),)}
    mine = found(run_port(rule, path, **kw_port))
    theirs = found(ref.run_lint(ref_cfg(path, rules=(rule,), **kw_ref)))
    assert mine == theirs
    assert bool(mine) == (case == "seeded")


@pytest.mark.parametrize("scope,expect", [(("serve",), 1), (("cases",), 0)])
def test_rng_key_draw_and_scope_match_the_reference(scope, expect):
    """A draw with a raw key on line 8, in each package's idiom: flagged
    at that line by both runners inside the serve scope, by neither
    outside it."""
    mine = run_port("rng-discipline", "serve/rng_key_bad.py",
                    rng_scope=scope, rng_global_scope=())
    theirs = ref.run_lint(ref_cfg("serve/rng_key_ref_bad.py",
                                  rules=("rng-discipline",), rng_scope=scope))
    assert [(v.rule, v.line) for v in mine.violations] == \
        [(v.rule, v.line) for v in theirs.violations] == \
        [("rng-discipline", 8)] * expect


# ---------------------------------------------------------------------------
# the port's own tree


def test_port_tree_lints_clean():
    """``python -m repro_torch.analysis --strict`` exits 0 on this tree:
    no finding outside the (empty) baseline, no stale entry."""
    r = port.run_lint(port.LintConfig(root=str(REPO)),
                      baseline=port.load_baseline(str(REPO / BASELINE)))
    rendered = "\n".join(v.render() for v in r.violations + r.parse_errors)
    assert not r.failed(strict=True), rendered or r.stale_baseline
    # the rules see the tree: roots reached, metrics and states found
    assert {v.rule for v, _ in r.suppressed} <= set(port.ALL_RULES)


def test_cli_strict_exits_zero_and_refuses_unknown_rules():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    ok = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                         "--strict"], env=env, capture_output=True,
                        text=True, timeout=120, cwd=str(REPO / "tests"))
    assert ok.returncode == 0, ok.stdout + ok.stderr
    assert "0 finding(s)" in ok.stdout
    bad = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                          "--rules", "jit-purity"], env=env,
                         capture_output=True, text=True, timeout=120)
    assert bad.returncode == 2 and "unknown rule" in bad.stderr
