"""Rule ``dispatch-purity``: no host effect inside a model step or a
kernel call; and rule ``wallclock``: no epoch clock in ``serve/`` or
``obs/``. Counterparts of ``repro.analysis.purity``'s ``jit-purity`` and
``wallclock``.

**dispatch-purity.** The port runs eagerly, so nothing runs "at trace
time only" as in the reference; what the rule keeps is the
metrics-on == metrics-off bitwise contract and bitwise replay. A model
step (``Model.mixed_step``, ``prefill``, ``decode_step``, ``logits``)
and a kernel wrapper (``kernels/ops.py``) must not print, open a file,
read a clock, draw from torch's / numpy's / the stdlib's global
generator, move a metric (``.inc`` / ``.observe`` / ``.set_max``, a
gauge's ``.set``), record a trace span, write the journal, or rebind a
module global (``global``). Observability lives around the step, in the
scheduler and the engine, never inside it. The roots are
``LintConfig.purity_roots``; everything reachable from them by name
(``callgraph``) is checked.

**wallclock.** ``time.time()`` in ``serve/`` or ``obs/`` stamps epoch
time into exported artifacts (metrics, journals), so two runs never
export the same bytes. Relative timers (``time.perf_counter``) stay
unflagged, as in the reference: the SLO tracker's wall series is never
compared bitwise. Epoch stamps come through an injectable clock.
"""
from __future__ import annotations

import ast
from typing import List

from repro_torch.analysis.base import ParsedFile, Project, Violation, \
    dotted_chain
from repro_torch.analysis.callgraph import build_index, reachable, \
    root_sites
from repro_torch.analysis.rng import global_draw

RULE_PURITY = "dispatch-purity"
RULE_WALLCLOCK = "wallclock"

# time.<attr> calls that read host clocks
CLOCK_ATTRS = {"time", "perf_counter", "monotonic", "process_time", "sleep",
               "time_ns", "perf_counter_ns", "monotonic_ns"}
# metric-instrument mutators (``set`` needs receiver evidence)
METRIC_MUTATORS = {"inc", "observe", "set_max"}
TRACER_METHODS = {"instant", "span"}


def _effects(file: ParsedFile, fn: ast.AST, origin: str
             ) -> List[Violation]:
    out: List[Violation] = []

    def flag(node: ast.AST, what: str) -> None:
        out.append(Violation(
            file.rel, node.lineno, RULE_PURITY,
            f"{what} inside a model step or kernel call (reached via "
            f"{origin}); host effects there break metrics-on == "
            f"metrics-off and bitwise replay"))

    body = fn.body if isinstance(fn.body, list) else [fn.body]
    for stmt in body:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Global):
                flag(node, "module-global rebinding (`global` statement)")
                continue
            if not isinstance(node, ast.Call):
                continue
            draw = global_draw(file, node)
            if draw is not None:
                flag(node, draw)
                continue
            chain = dotted_chain(node.func)
            if chain is None:
                continue
            name = chain[-1]
            if chain == ["print"]:
                flag(node, "print() call")
            elif chain == ["open"]:
                flag(node, "file I/O (open())")
            elif len(chain) == 2 and chain[0] == "time" \
                    and name in CLOCK_ATTRS:
                flag(node, f"host clock read (time.{name}())")
            elif name in METRIC_MUTATORS and len(chain) >= 2:
                flag(node, f"metric instrument call (.{name}())")
            elif name == "set" and len(chain) >= 2 and (
                    "metrics" in chain[:-1]
                    or chain[-2].startswith("_m")):
                flag(node, "metric gauge call (.set())")
            elif name in TRACER_METHODS and len(chain) >= 2 and (
                    "tracer" in chain[:-1] or chain[-2] in {"tr", "tracer"}):
                flag(node, f"trace recorder call (.{name}())")
            elif "journal" in chain[:-1]:
                flag(node, f"journal write (.{name}())")
    return out


def check_dispatch_purity(project: Project, roots) -> List[Violation]:
    idx = build_index(project)
    out: List[Violation] = []
    for root in roots:      # a renamed root would switch the rule off
        if project.get(root.partition("::")[0]) is not None and \
                not root_sites(project, idx, [root]):
            out.append(Violation(root.partition("::")[0], 1, RULE_PURITY,
                                 f"purity root {root} names no definition"))
    for site, origin in reachable(project, idx, roots):
        out.extend(_effects(site.file, site.node, origin))
    return sorted(set(out))


def check_wallclock(project: Project, scope) -> List[Violation]:
    out: List[Violation] = []
    for file in project.under(tuple(scope)):
        for node in ast.walk(file.tree):
            if not isinstance(node, ast.Call):
                continue
            if dotted_chain(node.func) == ["time", "time"]:
                out.append(Violation(
                    file.rel, node.lineno, RULE_WALLCLOCK,
                    "epoch wall-clock time.time() in a determinism-scoped "
                    "module; route it through an injectable clock (see "
                    "MetricsRegistry(clock=...)) so exports are "
                    "deterministic under test"))
    return out
