"""repro-lint for the port: stdlib-only static analysis of the invariants
the serving stack rests on, over ``src/repro_torch/`` and the ``chip_*.py``
scripts. The counterpart of ``repro.analysis``; run it with ``python -m
repro_torch.analysis`` (``--strict``, ``--rules``, ``--paths``,
``--baseline``, ``--write-baseline``)."""
from repro_torch.analysis.base import ParsedFile, Pragma, Project, Violation
from repro_torch.analysis.runner import (ALL_RULES, LintConfig, LintResult,
                                         load_baseline, run_lint,
                                         write_baseline)

__all__ = ["ParsedFile", "Pragma", "Project", "Violation", "ALL_RULES",
           "LintConfig", "LintResult", "load_baseline", "run_lint",
           "write_baseline"]
