"""Rule ``rng-discipline``: counter-based key streams in the serving
path, and no global generator where results must replay. Counterpart of
``repro.analysis.rng``.

Preempt-and-recompute is exact because every sample's token ``j`` is
drawn under ``fold_in(fold_in(PRNGKey(seed), sample_idx), j)``
(``serve/sampling.py``: ``request_base_key``, ``step_keys``), a pure
function of request constants. Under ``serve/`` the rule flags

  * a key draw (``gumbel``, ``random_bits``) whose key is not derived
    from a ``fold_in`` / ``step_keys`` / ``request_base_key`` chain:
    through simple assignments, subscripts and calls to project helpers
    whose bodies derive one (a draw wrapper's own key parameter is
    checked at its callers);
  * a draw that advances a stateful stream: any torch draw (a
    ``torch.Generator`` is a position in a stream, as ``jax.random.split``
    is in the reference), or a numpy generator method on a generator kept
    in a variable. A generator made at the draw from constants
    (``np.random.default_rng([seed, tick, salt]).random(2)``) is a
    counter-based stream and passes.

Under ``serve/``, ``train/``, ``core/`` and ``models/`` it flags every
draw from a global generator: a torch draw without an explicit
``generator=``, ``torch.manual_seed`` and its kin, a module-level
``np.random.<draw>``, and the stdlib's ``random``.
"""
from __future__ import annotations

import ast
from typing import List, Optional, Set

from repro_torch.analysis.base import ParsedFile, Project, Violation, \
    dotted_chain
from repro_torch.analysis.callgraph import DefIndex, build_index

RULE = "rng-discipline"

# the port's counter-based draws (serve/sampling.py): key first
KEY_DRAWS = {"gumbel", "random_bits"}
# names whose reference marks an expression as a derived key
DERIVERS = {"fold_in", "step_keys", "request_base_key"}
TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "multinomial",
               "bernoulli", "normal", "poisson", "rand_like", "randn_like",
               "randint_like"}
INPLACE_DRAWS = {"uniform_", "normal_", "bernoulli_", "exponential_",
                 "random_", "geometric_", "cauchy_", "log_normal_"}
TORCH_SEEDING = (["torch", "manual_seed"], ["torch", "seed"],
                 ["torch", "random", "manual_seed"],
                 ["torch", "random", "seed"],
                 ["torch", "cuda", "manual_seed"],
                 ["torch", "cuda", "manual_seed_all"])
# numpy.random names that build a generator rather than draw from the
# global one
NP_CONSTRUCTORS = {"default_rng", "Generator", "PCG64", "PCG64DXSM",
                   "Philox", "SFC64", "MT19937", "SeedSequence",
                   "BitGenerator"}
# numpy Generator draws (a receiver kept in a variable is a stream)
NP_GEN_DRAWS = {"random", "integers", "normal", "uniform", "choice",
                "permutation", "shuffle", "standard_normal", "exponential",
                "poisson", "binomial", "gumbel", "bytes", "multinomial",
                "standard_exponential", "standard_gamma", "beta", "gamma"}


def _has_stdlib_random(file: ParsedFile) -> bool:
    for node in ast.walk(file.tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name == "random" and alias.asname is None:
                    return True
    return False


def _has_generator(call: ast.Call) -> bool:
    return any(k.arg == "generator" for k in call.keywords)


def global_draw(file: ParsedFile, call: ast.Call) -> Optional[str]:
    """What global generator ``call`` draws from or reseeds, or None."""
    func = call.func
    if isinstance(func, ast.Attribute) and func.attr in INPLACE_DRAWS \
            and not _has_generator(call):
        return (f"in-place draw .{func.attr}() on torch's global generator "
                f"(no generator=)")
    chain = dotted_chain(func)
    if chain is None:
        return None
    if chain in TORCH_SEEDING:
        return f"{'.'.join(chain)}() reseeds torch's global generator"
    if len(chain) == 2 and chain[0] == "torch" and chain[1] in TORCH_DRAWS \
            and not _has_generator(call):
        return f"torch.{chain[1]}() on torch's global generator " \
               f"(no generator=)"
    if len(chain) == 3 and chain[0] in {"np", "numpy"} \
            and chain[1] == "random" and chain[2] not in NP_CONSTRUCTORS:
        return f"np.random.{chain[2]}() on numpy's global generator"
    if len(chain) == 2 and chain[0] == "random" and _has_stdlib_random(file):
        return f"stdlib random.{chain[1]}() (global-state RNG)"
    return None


def _derives(node: ast.AST) -> bool:
    """A deriver called or referenced anywhere in the subtree."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr in DERIVERS:
            return True
        if isinstance(sub, ast.Name) and sub.id in DERIVERS:
            return True
    return False


def _fn_body_derives(name: str, file: ParsedFile, idx: DefIndex) -> bool:
    site = idx.module_scope.get((file.rel, name))
    candidates = [site] if site else idx.by_name.get(name, [])
    return any(c and _derives(c.node) for c in candidates)


class _DrawChecker(ast.NodeVisitor):
    """One function scope: which local names hold derived keys, then each
    draw's key operand and each stateful draw."""

    def __init__(self, file: ParsedFile, idx: DefIndex, params: Set[str]):
        self.file = file
        self.idx = idx
        self.derived: Set[str] = set(params)
        self.out: List[Violation] = []

    def _expr_derived(self, node: ast.expr) -> bool:
        if _derives(node):
            return True
        if isinstance(node, ast.Name):
            return node.id in self.derived
        if isinstance(node, ast.Call):
            chain = dotted_chain(node.func)
            if chain and len(chain) == 1 and _fn_body_derives(
                    chain[0], self.file, self.idx):
                return True
            return any(self._expr_derived(a) for a in node.args)
        if isinstance(node, ast.Subscript):
            return self._expr_derived(node.value)
        return False

    def visit_Assign(self, node: ast.Assign) -> None:
        if self._expr_derived(node.value):
            for tgt in node.targets:
                for elt in (tgt.elts if isinstance(tgt, ast.Tuple)
                            else [tgt]):
                    if isinstance(elt, ast.Name):
                        self.derived.add(elt.id)
        self.generic_visit(node)

    def _flag(self, node: ast.AST, message: str) -> None:
        self.out.append(Violation(self.file.rel, node.lineno, RULE, message))

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        chain = dotted_chain(func)
        if chain and chain[-1] in KEY_DRAWS:
            key = node.args[0] if node.args else next(
                (k.value for k in node.keywords if k.arg == "keys"), None)
            if key is not None and not self._expr_derived(key):
                self._flag(node, f"{chain[-1]} key is not derived from a "
                                 f"fold_in counter chain; raw/reused keys "
                                 f"break bitwise replay under preemption "
                                 f"and restore")
        elif (chain and len(chain) == 2 and chain[0] == "torch"
              and chain[1] in TORCH_DRAWS) or (
                isinstance(func, ast.Attribute)
                and func.attr in INPLACE_DRAWS):
            self._flag(node, "torch draw in the serve path: a torch "
                             "generator is a stateful stream, so a replay "
                             "after preemption draws other numbers; derive "
                             "a counter-based key (step_keys) instead")
        elif isinstance(func, ast.Attribute) and func.attr in NP_GEN_DRAWS \
                and not self._fresh_numpy(func.value) \
                and not (chain and chain[0] in {"torch", "self", "np",
                                                "numpy", "random"}
                         and len(chain) <= 2):
            self._flag(node, f"numpy generator .{func.attr}() on a kept "
                             f"generator advances a stateful stream; make "
                             f"the generator at the draw from counters "
                             f"(np.random.default_rng([seed, tick, ...]))")
        self.generic_visit(node)

    @staticmethod
    def _fresh_numpy(recv: ast.expr) -> bool:
        """``np.random.default_rng(...)`` made at the draw."""
        if not isinstance(recv, ast.Call):
            return False
        chain = dotted_chain(recv.func)
        return bool(chain) and chain[-1] in {"default_rng", "Generator"}


def _params(fn) -> Set[str]:
    a = fn.args
    return {x.arg for x in a.posonlyargs + a.args + a.kwonlyargs}


def check_rng_discipline(project: Project, scope, global_scope=()
                         ) -> List[Violation]:
    idx = build_index(project)
    out: List[Violation] = []
    for file in project.under(tuple(scope)):
        for node in ast.walk(file.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                wrapper = getattr(node, "name", "") in KEY_DRAWS
                checker = _DrawChecker(file, idx,
                                       _params(node) if wrapper else set())
                body = node.body if isinstance(node.body, list) \
                    else [node.body]
                for stmt in body:
                    checker.visit(stmt)
                out.extend(checker.out)
    for file in project.under(tuple(global_scope)):
        for node in ast.walk(file.tree):
            if isinstance(node, ast.Call):
                what = global_draw(file, node)
                if what is not None:
                    out.append(Violation(
                        file.rel, node.lineno, RULE,
                        f"{what}: a draw from a global generator depends on "
                        f"every draw before it in the process, so results "
                        f"do not replay; pass an explicit seeded generator"))
    return sorted(set(out))
