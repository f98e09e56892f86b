"""Rule ``metric-catalog``: the metric names the code emits and the
catalog rows must match both ways. Counterpart of
``repro.analysis.catalog``'s rule of that name (``bench-keys`` has none:
the port has no bench file).

Code-side names come from ``.counter / .gauge / .histogram("name", ...)``
calls on a metrics registry (a receiver named ``m`` / ``registry`` /
``reg`` or reached through ``metrics``; the trace recorder's
``tr.counter(...)`` channel is not one); an f-string name such as
``f"sched_shed_{reason}_total"`` becomes a wildcard. Catalog names are
the backticked first cells of the table rows of each catalog document
(``docs/observability.md``, which the port shares with the reference,
and the port's own section for names only it emits), where
``sched_shed_<reason>_total`` is the same wildcard. A code name in no
catalog is undocumented; a row that no code name matches is rot.
"""
from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.base import Project, Violation, dotted_chain

RULE_CATALOG = "metric-catalog"

METRIC_FACTORIES = {"counter", "gauge", "histogram"}
# receiver spellings that denote the obs metrics registry
_REGISTRY_BASES = {"m", "registry", "metrics", "reg"}

_BACKTICK_RE = re.compile(r"`([A-Za-z0-9_<>{}*]+)`")
_WILD_RE = re.compile(r"<[^<>]+>|\{[^{}]+\}")


def _normalize(name: str) -> str:
    """``sched_shed_<reason>_total`` / ``..._{reason}_...`` -> ``*``."""
    return _WILD_RE.sub("*", name)


def _pattern_matches(pattern: str, name: str) -> bool:
    if "*" not in pattern:
        return pattern == name
    return re.fullmatch(
        "[A-Za-z0-9_]+".join(re.escape(p) for p in pattern.split("*")),
        name) is not None


def _is_registry_recv(func: ast.expr) -> bool:
    chain = dotted_chain(func)
    if not chain or len(chain) < 2 or chain[-1] not in METRIC_FACTORIES:
        return False
    recv = chain[:-1]
    return recv[-1] in _REGISTRY_BASES or "metrics" in recv


def _name_arg(call: ast.Call) -> Optional[str]:
    """The first argument as a (possibly wildcard) metric name."""
    if not call.args:
        return None
    arg = call.args[0]
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return arg.value
    if isinstance(arg, ast.JoinedStr):
        return "".join(str(p.value) if isinstance(p, ast.Constant) else "*"
                       for p in arg.values)
    return None   # a name built elsewhere: out of static reach


def code_metrics(project: Project, scope) -> List[Tuple[str, str, int]]:
    """(name or pattern, file, line) of every registry call in scope."""
    out = []
    for f in project.under(tuple(scope)):
        for node in ast.walk(f.tree):
            if isinstance(node, ast.Call) and _is_registry_recv(node.func):
                name = _name_arg(node)
                if name is not None:
                    out.append((_normalize(name), f.rel, node.lineno))
    return out


def doc_metrics(doc_text: str) -> Dict[str, int]:
    """Catalog entries -> their first line: every backticked token in a
    table row's first cell, and wildcard tokens anywhere (a pattern
    explained in prose still pairs with its code site)."""
    entries: Dict[str, int] = {}
    for i, line in enumerate(doc_text.splitlines(), start=1):
        stripped = line.strip()
        if stripped.startswith("|"):
            cells = [c.strip() for c in stripped.strip("|").split("|")]
            if cells and not set(cells[0]) <= {"-", ":", " "}:
                for tok in _BACKTICK_RE.findall(cells[0]):
                    entries.setdefault(_normalize(tok), i)
        for tok in _BACKTICK_RE.findall(stripped):
            if "<" in tok or "{" in tok:
                entries.setdefault(_normalize(tok), i)
    return entries


def _section(text: str, heading: str) -> Tuple[str, int]:
    """The lines of the markdown section titled ``heading`` (to the next
    heading of its level or above) and the line before its first one;
    the whole text for an empty heading."""
    if not heading:
        return text, 0
    lines = text.splitlines()
    for i, line in enumerate(lines):
        m = re.match(r"(#+)\s+(.*?)\s*$", line)
        if m and m.group(2) == heading:
            level = len(m.group(1))
            end = len(lines)
            for j in range(i + 1, len(lines)):
                n = re.match(r"(#+)\s", lines[j])
                if n and len(n.group(1)) <= level:
                    end = j
                    break
            return "\n".join(lines[i:end]), i
    return "", 0


def check_metric_catalog(project: Project, scope,
                         docs: Sequence[Tuple[str, str]]
                         ) -> List[Violation]:
    """``docs``: (file, section heading or "" for the whole file) of each
    catalog."""
    catalog: Dict[str, Tuple[str, int]] = {}
    out: List[Violation] = []
    for rel, heading in docs:
        try:
            with open(os.path.join(project.root, rel), "r",
                      encoding="utf-8") as fh:
                text = fh.read()
        except OSError as exc:
            out.append(Violation(rel, 1, RULE_CATALOG,
                                 f"metric catalog unreadable: {exc}"))
            continue
        text, offset = _section(text, heading)
        for name, line in doc_metrics(text).items():
            catalog.setdefault(name, (rel, line + offset))
    if out:
        return out
    code = code_metrics(project, scope)
    where = " or ".join(rel for rel, _ in docs)

    for name, rel, line in code:
        if not any(d == name or _pattern_matches(d, name)
                   or _pattern_matches(name, d) for d in catalog):
            out.append(Violation(
                rel, line, RULE_CATALOG,
                f"metric `{name}` is emitted here but has no row in "
                f"{where}; undocumented metrics rot first"))

    code_names = {n for n, _, _ in code}
    for doc_name, (rel, line) in sorted(catalog.items()):
        if doc_name in code_names or any(
                _pattern_matches(doc_name, c) or _pattern_matches(c, doc_name)
                for c in code_names):
            continue
        out.append(Violation(
            rel, line, RULE_CATALOG,
            f"catalog row `{doc_name}` matches no metric emitted in "
            f"{'/'.join(scope)}; stale rows make the catalog untrustworthy"))
    return out
