"""A project-wide call-graph walk from named roots: the port's
counterpart of ``repro.analysis.callgraph``.

The reference walks from every ``jax.jit`` / ``pl.pallas_call`` entry
point, whose Python body runs only while tracing. The port runs eagerly;
its counterpart of "traced code" is the code that runs inside one
model step or kernel call, where an effect (a metric, a clock read, a
draw from a global generator) would make metrics-on differ from
metrics-off or a replay from its original. So the roots are named:
``"<file>::<Class>.<method>"`` or ``"<file>::<function>"``, and
``"<file>::*"`` for every public module-level function of a file (the
kernel wrappers of ``kernels/ops.py``).

Resolution is by name and over-approximate, with the reference's two
dampers:

  * attribute chains rooted at a library (``torch.``, ``F.``, ``np.``,
    ``math.`` ...) are never resolved into project code;
  * names that collide with ubiquitous container / tensor methods
    (``get``, ``view``, ``sum`` ...) are resolved only within the caller's
    class or module, never across the project.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Set, Tuple, Union

from repro_torch.analysis.base import ParsedFile, Project, dotted_chain

FuncNode = Union[ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda]

# library roots whose attribute calls are never project code
LIB_ROOTS = {"torch", "F", "nn", "np", "numpy", "math", "functools",
             "itertools", "os", "sys", "json", "re", "ast", "ctypes",
             "dist", "contextlib", "collections", "dataclasses", "typing",
             "subprocess", "threading", "hashlib", "shutil", "weakref"}

# terminal names too generic to resolve across the project
GENERIC_NAMES = {
    "get", "set", "update", "append", "appendleft", "add", "pop", "popleft",
    "items", "keys", "values", "extend", "remove", "insert", "index",
    "count", "sort", "copy", "clear", "join", "split", "format", "replace",
    "startswith", "endswith", "strip", "astype", "reshape", "transpose",
    "squeeze", "ravel", "flatten", "sum", "mean", "max", "min", "all",
    "any", "dot", "tolist", "item", "read", "write", "close", "flush",
    "setdefault", "extendleft", "view", "to", "float", "contiguous",
    "expand", "permute", "unsqueeze", "chunk", "narrow", "size", "dim",
    "numel", "cpu", "cuda", "detach", "clone", "fill_", "zero_", "copy_",
    "add_", "mul_", "type", "init", "run", "apply", "forward", "step",
    "load", "save", "build",
}

BUILTINS = {"int", "float", "bool", "str", "len", "range", "zip", "tuple",
            "enumerate", "list", "dict", "set", "frozenset", "sorted",
            "min", "max", "abs", "sum", "isinstance", "getattr", "hasattr",
            "type", "super", "print", "repr", "round", "map", "filter",
            "reversed", "iter", "next", "id", "vars", "callable", "open",
            "divmod", "any", "all", "setattr"}


@dataclass(frozen=True)
class DefSite:
    """One function or method definition: where it lives and its class."""
    file: ParsedFile
    node: FuncNode
    cls: Optional[str]          # enclosing class name, None at module level

    @property
    def name(self) -> str:
        return getattr(self.node, "name", "<lambda>")


@dataclass
class DefIndex:
    """Project-wide map of function definitions, by name and by class."""
    by_name: Dict[str, List[DefSite]] = field(default_factory=dict)
    by_class: Dict[Tuple[str, str], List[DefSite]] = field(
        default_factory=dict)     # (class name, method name) -> sites
    module_scope: Dict[Tuple[str, str], DefSite] = field(
        default_factory=dict)     # (file rel, func name) -> site


def build_index(project: Project) -> DefIndex:
    idx = DefIndex()

    def visit(file: ParsedFile, node: ast.AST, cls: Optional[str],
              top: bool) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                site = DefSite(file, child, cls)
                idx.by_name.setdefault(child.name, []).append(site)
                if cls is not None:
                    idx.by_class.setdefault((cls, child.name),
                                            []).append(site)
                elif top:
                    idx.module_scope[(file.rel, child.name)] = site
                # nested defs resolve by name only
                visit(file, child, cls, False)
            elif isinstance(child, ast.ClassDef):
                visit(file, child, child.name, False)

    for file in project.files.values():
        visit(file, file.tree, None, True)
    return idx


def resolve_ref(ref: ast.expr, file: ParsedFile, cls: Optional[str],
                idx: DefIndex) -> List[DefSite]:
    """A function-reference expression -> candidate definition sites:
    lambda (inline) > same-class method (``self.x``) > same-module
    function > project-wide by a distinctive name. Library functions,
    builtins and locals resolve to nothing."""
    if isinstance(ref, ast.Lambda):
        return [DefSite(file, ref, cls)]
    chain = dotted_chain(ref)
    if not chain:
        return []
    name = chain[-1]
    if chain[0] in LIB_ROOTS and len(chain) > 1:
        return []
    if name in BUILTINS and len(chain) == 1:
        return []
    if len(chain) >= 2 and chain[0] == "self" and cls is not None:
        sites = idx.by_class.get((cls, name))
        if sites:
            return sites
    site = idx.module_scope.get((file.rel, name))
    if site is not None:
        return [site]
    if name in GENERIC_NAMES or name.startswith("__"):
        return []
    return idx.by_name.get(name, [])


def called_refs(fn: FuncNode) -> List[ast.expr]:
    """Function references called inside ``fn``, nested defs and lambdas
    included (they run inside the call)."""
    refs: List[ast.expr] = []
    body = fn.body if isinstance(fn.body, list) else [fn.body]
    for stmt in body:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Call) and not isinstance(node.func,
                                                             ast.Call):
                refs.append(node.func)
    return refs


def root_sites(project: Project, idx: DefIndex,
               roots: Iterable[str]) -> List[Tuple[DefSite, str]]:
    """The definitions named by ``roots`` (module note), each with its
    root's name."""
    out: List[Tuple[DefSite, str]] = []
    for root in roots:
        rel, _, what = root.partition("::")
        file = project.get(rel)
        if file is None:
            continue
        if what == "*":
            for (r, name), site in sorted(idx.module_scope.items(),
                                          key=lambda kv: kv[0]):
                if r == rel and not name.startswith("_"):
                    out.append((site, f"{rel}::{name}"))
            continue
        cls, _, name = what.rpartition(".")
        sites = (idx.by_class.get((cls, name), []) if cls else
                 [s for s in [idx.module_scope.get((rel, name))] if s])
        out.extend((s, root) for s in sites if s.file.rel == rel)
    return out


def reachable(project: Project, idx: DefIndex, roots: Iterable[str]
              ) -> List[Tuple[DefSite, str]]:
    """Every definition reachable from a root, with a readable path from
    its root for messages; deduplicated by (file, line)."""
    seen: Set[Tuple[str, int]] = set()
    out: List[Tuple[DefSite, str]] = []
    work = [(site, f"root {name}") for site, name in
            root_sites(project, idx, roots)]
    while work:
        site, origin = work.pop()
        key = (site.file.rel, site.node.lineno)
        if key in seen:
            continue
        seen.add(key)
        out.append((site, origin))
        for ref in called_refs(site.node):
            for callee in resolve_ref(ref, site.file, site.cls, idx):
                work.append(
                    (callee, f"{origin} -> {site.file.rel}:{site.name}"))
    return out
