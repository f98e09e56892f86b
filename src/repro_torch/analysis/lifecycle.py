"""Rule ``state-exhaustive``: terminal-state dispatch must be total
(``repro.analysis.lifecycle``'s rule over the port's scheduler and
recovery).

A request ends in one of the states of ``TERMINAL_STATES``
(``serve/scheduler.py``). Every site in ``scheduler.py`` / ``recovery.py``
that dispatches on a terminal state (an if / elif ladder, a membership
test against a written-out tuple of states, a dict keyed or valued by
states) is where a new state would fall through: its request would leak
its pages and journal no terminal record. Each such site must

  * cover every state of ``TERMINAL_STATES`` (a superset is fine), or
  * test membership in ``TERMINAL_STATES`` itself, or
  * end its if / elif ladder in an ``else`` arm that raises.

Sites mixing terminal and live states, or naming fewer than two terminal
states, are not dispatch sites and are skipped.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.base import (Project, Violation, const_str,
                                       dotted_chain, module_string_constants,
                                       module_tuple_assignment)

RULE = "state-exhaustive"
CANONICAL = "TERMINAL_STATES"


def _terminal_states(project: Project, state_module: str
                     ) -> Tuple[Optional[Set[str]], List[Violation]]:
    """The canonical terminal-state string set from ``state_module``."""
    f = project.get(state_module)
    if f is None:
        return None, []
    consts = module_string_constants(f.tree)
    found = module_tuple_assignment(f.tree, CANONICAL)
    if found is None:
        return None, [Violation(
            state_module, 1, RULE,
            f"no module-level {CANONICAL} tuple; the lifecycle rule needs "
            f"a canonical terminal-state set to check dispatch sites "
            f"against")]
    node, elts = found
    states: Set[str] = set()
    for elt in elts:
        s = const_str(elt)
        if s is None and isinstance(elt, ast.Name):
            s = consts.get(elt.id)
        if s is not None:
            states.add(s)
    return states, []


def _state_value(node: ast.expr, consts: Dict[str, str]) -> Optional[str]:
    s = const_str(node)
    if s is not None:
        return s
    if isinstance(node, ast.Name):
        return consts.get(node.id)
    chain = dotted_chain(node)
    if chain and len(chain) >= 2:
        # scheduler.FINISHED style cross-module reference
        return consts.get(chain[-1])
    return None


def _subject_repr(node: ast.expr) -> Optional[str]:
    """A stable key for 'the thing being dispatched on' — e.g.
    ``req.state`` — so an if/elif ladder over one subject groups."""
    chain = dotted_chain(node)
    if chain is None:
        return None
    if chain[-1] in {"state", "status", "terminal_state"}:
        return ".".join(chain)
    return None


def _membership(test: ast.expr) -> Optional[Tuple[ast.expr, ast.expr, bool]]:
    """``subj in (A, B)`` / ``subj not in (...)`` ->
    (subject, container, negated)."""
    if isinstance(test, ast.Compare) and len(test.ops) == 1 \
            and isinstance(test.ops[0], (ast.In, ast.NotIn)):
        return (test.left, test.comparators[0],
                isinstance(test.ops[0], ast.NotIn))
    return None


def _equality(test: ast.expr) -> Optional[Tuple[ast.expr, ast.expr]]:
    if isinstance(test, ast.Compare) and len(test.ops) == 1 \
            and isinstance(test.ops[0], ast.Eq):
        return test.left, test.comparators[0]
    return None


def _raises(stmts: Sequence[ast.stmt]) -> bool:
    return any(isinstance(n, ast.Raise)
               for s in stmts for n in ast.walk(s))


def check_state_exhaustive(project: Project, lifecycle_files,
                           state_module: str) -> List[Violation]:
    terminals, out = _terminal_states(project, state_module)
    if terminals is None:
        return out

    for rel in lifecycle_files:
        f = project.get(rel)
        if f is None:
            continue
        consts = module_string_constants(f.tree)
        handled_ifs: Set[int] = set()

        for node in ast.walk(f.tree):
            # --- dict literals keyed/valued by terminal states ---------
            # (recovery.py maps journal strings -> state constants in the
            # values; the scheduler's per-state counters use states as
            # keys — both shapes must be total)
            if isinstance(node, ast.Dict):
                for elts in (node.keys, node.values):
                    vals = {_state_value(e, consts) for e in elts
                            if e is not None}
                    vals.discard(None)
                    named = vals & terminals
                    if len(named) >= 2 and not (terminals <= vals):
                        missing = sorted(terminals - vals)
                        out.append(Violation(
                            f.rel, node.lineno, RULE,
                            f"terminal-state mapping misses "
                            f"{', '.join(missing)}; every terminal state "
                            f"needs an arm so a future state cannot fall "
                            f"through silently"))
                        break
                continue

            # --- membership tests against literal state tuples ---------
            if isinstance(node, ast.Compare):
                mem = _membership(node)
                if mem is None:
                    continue
                subj, container, _neg = mem
                if _subject_repr(subj) is None:
                    continue
                chain = dotted_chain(container)
                if chain and chain[-1] == CANONICAL:
                    continue   # canonical spelling — total by definition
                if isinstance(container, (ast.Tuple, ast.List, ast.Set)):
                    vals = {_state_value(e, consts)
                            for e in container.elts}
                    vals.discard(None)
                    named = vals & terminals
                    if not named or len(named) < 2:
                        continue
                    if vals - terminals:
                        continue   # mixed live/terminal test — not a
                                   # terminal dispatch site
                    if not (terminals <= vals):
                        missing = sorted(terminals - vals)
                        out.append(Violation(
                            f.rel, node.lineno, RULE,
                            f"terminal-state membership test misses "
                            f"{', '.join(missing)}; use {CANONICAL} or "
                            f"enumerate every terminal state"))
                continue

            # --- if/elif ladders over one state subject -----------------
            if isinstance(node, ast.If) and node.lineno not in handled_ifs:
                covered: Set[str] = set()
                subjects: Set[str] = set()
                cur: Optional[ast.If] = node
                arms = 0
                last = node
                while isinstance(cur, ast.If):
                    handled_ifs.add(cur.lineno)
                    eq = _equality(cur.test)
                    if eq is not None:
                        subj_r = _subject_repr(eq[0])
                        val = _state_value(eq[1], consts)
                        if subj_r is not None and val in terminals:
                            subjects.add(subj_r)
                            covered.add(val)
                            arms += 1
                    last = cur
                    nxt = cur.orelse
                    cur = nxt[0] if len(nxt) == 1 \
                        and isinstance(nxt[0], ast.If) else None
                if arms >= 2 and len(subjects) == 1 \
                        and not (terminals <= covered):
                    tail = last.orelse
                    if not (tail and _raises(tail)):
                        missing = sorted(terminals - covered)
                        out.append(Violation(
                            f.rel, node.lineno, RULE,
                            f"state dispatch ladder misses "
                            f"{', '.join(missing)} and has no raising "
                            f"else arm; a new terminal state would fall "
                            f"through silently"))
    return out
