"""Shared infrastructure of the port's ``repro-lint`` suite, the
counterpart of ``repro.analysis.base``.

The serving stack's guarantees (bitwise streams under preemption and
restore, metrics-on == metrics-off, counter-based RNG replay) are held at
run time by parity tests and chaos soaks. This package is their static
half over ``src/repro_torch/``: ``ast`` rules that reject a diff breaking
one of them before a soak runs. It imports the standard library only
(no torch, no jax, nothing of either package it reads).

  * :class:`Violation`: one finding, ``path:line rule-id message``; its
    baseline fingerprint drops the line, so code shifting down does not
    break a committed baseline entry.
  * :class:`ParsedFile` / :class:`Project`: parsed sources and their
    repository-relative paths.
  * Inline pragmas: ``# repro-lint: allow[rule-id] <reason>`` on the
    line or the line above suppresses that rule there; the reason is
    required, and a bare ``allow`` suppresses nothing.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass(frozen=True, order=True)
class Violation:
    """One lint finding. ``path`` is repo-relative posix."""
    path: str
    line: int
    rule: str
    message: str

    @property
    def fingerprint(self) -> str:
        """Line-number-free identity used by the allowlist baseline."""
        return f"{self.path}:{self.rule}:{self.message}"

    def render(self) -> str:
        return f"{self.path}:{self.line} {self.rule} {self.message}"


# ``# repro-lint: allow[rule-a,rule-b] reason text``
PRAGMA_RE = re.compile(
    r"#\s*repro-lint:\s*allow\[([A-Za-z0-9_\-, ]+)\]\s*(.*?)\s*$")


@dataclass
class Pragma:
    line: int
    rules: Tuple[str, ...]
    reason: str


class ParsedFile:
    """One source file: text, AST, and its inline lint pragmas."""

    def __init__(self, rel: str, source: str, tree: ast.AST):
        self.rel = rel                        # repo-relative posix path
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree
        self.pragmas: Dict[int, Pragma] = {}
        for i, text in enumerate(self.lines, start=1):
            m = PRAGMA_RE.search(text)
            if m:
                rules = tuple(r.strip() for r in m.group(1).split(",")
                              if r.strip())
                self.pragmas[i] = Pragma(i, rules, m.group(2).strip())

    def pragma_for(self, line: int, rule: str) -> Optional[Pragma]:
        """The pragma suppressing ``rule`` at ``line``: same line or the
        line directly above. Reasonless pragmas never suppress."""
        for ln in (line, line - 1):
            p = self.pragmas.get(ln)
            if p and rule in p.rules and p.reason:
                return p
        return None


@dataclass
class Project:
    """The analyzed file set plus repo-root bookkeeping. ``files`` maps
    repo-relative posix paths to parsed sources; rules that read
    non-Python inputs (docs, JSON manifests) resolve them against
    ``root`` so fixture tests can point a rule at a corpus of their own.
    """
    root: str
    files: Dict[str, ParsedFile] = field(default_factory=dict)

    def get(self, rel: str) -> Optional[ParsedFile]:
        return self.files.get(rel)

    def under(self, prefixes: Tuple[str, ...]) -> List[ParsedFile]:
        """Files whose repo-relative path starts with any prefix."""
        return [f for rel, f in sorted(self.files.items())
                if any(rel == p or rel.startswith(p.rstrip("/") + "/")
                       for p in prefixes)]


def dotted_chain(node: ast.AST) -> Optional[List[str]]:
    """Flatten ``a.b.c`` into ``["a", "b", "c"]``; None when the chain
    passes through anything that is not a plain Name/Attribute (calls,
    subscripts — e.g. ``x.at[i].set`` yields None past the subscript)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return list(reversed(parts))
    return None


def const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def module_string_constants(tree: ast.AST) -> Dict[str, str]:
    """Module-level ``NAME = "literal"`` assignments (the lifecycle-state
    and enum rules resolve constant Names through this map). Tuple
    unpacking assignments (``A, B = "a", "b"``) are included."""
    out: Dict[str, str] = {}
    for node in ast.iter_child_nodes(tree):
        if not isinstance(node, ast.Assign):
            continue
        for tgt in node.targets:
            if isinstance(tgt, ast.Name):
                s = const_str(node.value)
                if s is not None:
                    out[tgt.id] = s
            elif (isinstance(tgt, ast.Tuple)
                  and isinstance(node.value, ast.Tuple)
                  and len(tgt.elts) == len(node.value.elts)):
                for t, v in zip(tgt.elts, node.value.elts):
                    s = const_str(v)
                    if isinstance(t, ast.Name) and s is not None:
                        out[t.id] = s
    return out


def module_tuple_assignment(tree: ast.AST, symbol: str
                            ) -> Optional[Tuple[ast.Assign, List[ast.expr]]]:
    """The module-level ``SYMBOL = (elt, ...)`` assignment, if any."""
    for node in ast.iter_child_nodes(tree):
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if (isinstance(tgt, ast.Name) and tgt.id == symbol
                        and isinstance(node.value, (ast.Tuple, ast.List))):
                    return node, list(node.value.elts)
    return None
