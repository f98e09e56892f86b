"""repro-lint over the port's tree: ``python -m repro_torch.analysis``.

    python -m repro_torch.analysis                  # new findings fail
    python -m repro_torch.analysis --strict         # stale baseline
                                                    # entries fail too
    python -m repro_torch.analysis --rules dispatch-purity,wallclock
    python -m repro_torch.analysis --paths src/repro_torch/serve
    python -m repro_torch.analysis --write-baseline # accept the findings

Exit code 0: clean (up to the baseline); 1: findings or stale entries;
2: a usage error. The repository root is found from this file, so the
command runs from anywhere with ``src`` on the path.
"""
from __future__ import annotations

import argparse
import os
import sys

from repro_torch.analysis import (ALL_RULES, LintConfig, load_baseline,
                                  run_lint, write_baseline)
from repro_torch.analysis.runner import BASELINE

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--strict", action="store_true",
                    help="fail on stale baseline entries as well")
    ap.add_argument("--paths", default=None,
                    help="comma-separated roots to lint (default: "
                         "src/repro_torch and the chip_*.py scripts)")
    ap.add_argument("--rules", default=None,
                    help=f"comma-separated rule subset of: "
                         f"{','.join(ALL_RULES)}")
    ap.add_argument("--baseline", default=BASELINE,
                    help="allowlist baseline path (repository-relative)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="accept all current findings into the baseline")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress the summary line")
    args = ap.parse_args(argv)

    kwargs = {"root": REPO_ROOT}
    if args.paths:
        kwargs["paths"] = tuple(p.strip() for p in args.paths.split(",")
                                if p.strip())
    if args.rules:
        rules = tuple(r.strip() for r in args.rules.split(",") if r.strip())
        unknown = sorted(set(rules) - set(ALL_RULES))
        if unknown:
            sys.stderr.write(f"unknown rule(s): {', '.join(unknown)}\n")
            return 2
        kwargs["rules"] = rules
    cfg = LintConfig(**kwargs)

    baseline_path = os.path.join(REPO_ROOT, args.baseline)
    result = run_lint(cfg, baseline=load_baseline(baseline_path))

    if args.write_baseline:
        n = len(result.violations) + len(result.baselined)
        write_baseline(baseline_path, result.violations + result.baselined)
        print(f"wrote {n} fingerprint(s) to {args.baseline}")
        return 0

    for v in result.parse_errors + result.violations:
        print(v.render())
    if args.strict:
        for fp in result.stale_baseline:
            print(f"{args.baseline}:1 stale-baseline allowlist entry "
                  f"matches nothing: {fp}")
    if not args.quiet:
        n_stale = len(result.stale_baseline)
        print(f"repro-lint: {len(result.violations)} finding(s), "
              f"{len(result.baselined)} baselined, "
              f"{len(result.suppressed)} pragma-suppressed, "
              f"{n_stale} stale baseline entr"
              f"{'y' if n_stale == 1 else 'ies'}, "
              f"{len(result.parse_errors)} parse error(s)")
    return 1 if result.failed(strict=args.strict) else 0


if __name__ == "__main__":
    sys.exit(main())
