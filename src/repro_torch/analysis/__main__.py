"""``python -m repro_torch.analysis`` — the port's static-analysis gate.

Default run (no args): lint every ``*.py`` under ``src/repro_torch`` and
verify the registry contracts for every smoke config. Findings print as
``file:line: [rule-id] message`` + a fix hint; exit status is non-zero
iff there are findings not covered by the checked-in baseline
(``repro_torch/analysis/baseline.json`` — empty on the merged tree) or any
contract violation. The default path is the port's package, not ``src``:
the reference's package has its own gate (``python -m repro.analysis``).

    python -m repro_torch.analysis                     # lint + contracts
    python -m repro_torch.analysis path/to/file.py     # lint given paths
    python -m repro_torch.analysis --no-contracts      # lint only
    python -m repro_torch.analysis --contracts-only    # contracts only
    python -m repro_torch.analysis --family gemma3-1b  # restrict the matrix
    python -m repro_torch.analysis --write-baseline    # accept findings
    python -m repro_torch.analysis --rules             # list rules and exit
"""
from __future__ import annotations

import argparse
import sys

from .lint import (DEFAULT_BASELINE, lint_paths, load_baseline, partition,
                   save_baseline)
from .rules import RULES


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="serving-invariant linter + registry contract verifier")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/dirs to lint (default: src/repro_torch)")
    ap.add_argument("--baseline", default=str(DEFAULT_BASELINE),
                    help="baseline JSON (default: the checked-in one)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="accept current lint findings into the baseline")
    ap.add_argument("--no-contracts", action="store_true",
                    help="skip the registry contract verifier")
    ap.add_argument("--contracts-only", action="store_true",
                    help="run only the registry contract verifier")
    ap.add_argument("--family", action="append", default=None,
                    metavar="TAG", help="restrict contracts to these arch "
                    "tags (repeatable)")
    ap.add_argument("--rules", action="store_true",
                    help="list lint rules and exit")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="print findings only, no summary chatter")
    args = ap.parse_args(argv)

    if args.rules:
        for r in RULES:
            mod = sys.modules[type(r).__module__]
            doc = (mod.__doc__ or "").strip().splitlines()
            head = doc[0] if doc else ""
            print(f"{r.rule_id:24s} {head}")
        return 0

    status = 0
    if not args.contracts_only:
        paths = args.paths or ["src/repro_torch"]
        findings = lint_paths(paths)
        baseline = load_baseline(args.baseline)
        new, old = partition(findings, baseline)
        if args.write_baseline:
            save_baseline(findings, args.baseline)
            print(f"repro_torch.analysis: wrote {len(findings)} finding(s) to "
                  f"{args.baseline}")
            new = []
        for f in new:
            print(f.render())
        if old and not args.quiet:
            print(f"repro_torch.analysis: {len(old)} baselined finding(s) "
                  "suppressed")
        if new:
            status = 1
        if not args.quiet:
            n_files = len(set(f.path for f in findings)) if findings else 0
            print(f"repro_torch.analysis: lint {'FAILED' if new else 'OK'} — "
                  f"{len(new)} new finding(s) ({len(old)} baselined, "
                  f"{n_files} file(s) with findings)")

    if not args.no_contracts:
        from .contracts import default_matrix, verify_all
        matrix = None
        if args.family:
            matrix = [(t, c) for t, c in default_matrix()
                      if t in set(args.family)]
            missing = set(args.family) - {t for t, _ in matrix}
            if missing:
                print(f"repro_torch.analysis: unknown --family tag(s) "
                      f"{sorted(missing)}")
                return 2
        reports = verify_all(matrix)
        bad = [r for r in reports if not r.ok]
        for r in bad:
            for f in r.findings:
                print(f.render())
        if bad:
            status = 1
        if not args.quiet:
            fams = sorted({r.family for r in reports if "," not in r.family})
            print(f"repro_torch.analysis: contracts "
                  f"{'FAILED' if bad else 'OK'} — {len(reports)} "
                  f"config(s) over families {fams}")
    return status


if __name__ == "__main__":
    sys.exit(main())
