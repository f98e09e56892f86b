"""Rule ``enum-append``: order-sensitive enums only grow at the end
(``repro.analysis.enums``'s rule over the port's enums).

``FAULT_KINDS`` positions salt the chaos plan's per-tick streams
(``serve/faults.py``), ``PRIORITIES`` order queue arbitration, and the
journal records ``TERMINAL_STATES`` by name: reordering, renaming or
removing an entry reshuffles every recorded chaos schedule and soak
repro. The committed manifest (``enum_manifest.json`` of this package)
pins each tuple's prefix: the live tuple must start with it in the same
order, and an entry appended to the tuple is appended to the manifest in
the same diff.
"""
from __future__ import annotations

import json
import os
from typing import List, Optional

from repro_torch.analysis.base import (Project, Violation, const_str,
                                       module_string_constants,
                                       module_tuple_assignment)

RULE = "enum-append"


def _live_tuple(project: Project, rel: str, symbol: str
                ) -> Optional[List[str]]:
    f = project.get(rel)
    if f is None:
        return None
    found = module_tuple_assignment(f.tree, symbol)
    if found is None:
        return None
    _node, elts = found
    consts = module_string_constants(f.tree)
    vals: List[str] = []
    for elt in elts:
        s = const_str(elt)
        if s is None and hasattr(elt, "id"):
            s = consts.get(elt.id)
        if s is None:
            return None   # non-literal element — cannot check statically
        vals.append(s)
    return vals


def check_enum_append(project: Project, manifest_path: str
                      ) -> List[Violation]:
    out: List[Violation] = []
    path = os.path.join(project.root, manifest_path)
    try:
        with open(path, "r", encoding="utf-8") as fh:
            manifest = json.load(fh)
    except (OSError, json.JSONDecodeError) as exc:
        return [Violation(manifest_path, 1, RULE,
                          f"enum manifest unreadable: {exc}")]

    for key, pinned in sorted(manifest.items()):
        if key.startswith("_"):
            continue
        rel, _, symbol = key.partition("::")
        live = _live_tuple(project, rel, symbol)
        if live is None:
            if project.get(rel) is not None:
                out.append(Violation(
                    rel, 1, RULE,
                    f"manifest pins {symbol} but no statically-readable "
                    f"module-level tuple assignment was found"))
            continue
        # line number of the assignment, for the report
        node, _ = module_tuple_assignment(project.get(rel).tree, symbol)
        line = node.lineno
        if len(live) < len(pinned):
            out.append(Violation(
                rel, line, RULE,
                f"{symbol} has {len(live)} entries but the manifest pins "
                f"{len(pinned)}; entries were removed — order-sensitive "
                f"enums are append-only"))
        elif live[:len(pinned)] != list(pinned):
            out.append(Violation(
                rel, line, RULE,
                f"{symbol} prefix diverges from the manifest "
                f"({live[:len(pinned)]} vs pinned {list(pinned)}); "
                f"reordering/renaming reshuffles every recorded schedule "
                f"keyed by index"))
        elif len(live) > len(pinned):
            out.append(Violation(
                rel, line, RULE,
                f"{symbol} grew to {len(live)} entries but the manifest "
                f"still pins {len(pinned)}; append the new entries to "
                f"{manifest_path} in the same diff"))
    return out
