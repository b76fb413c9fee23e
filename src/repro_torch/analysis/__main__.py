"""CLI: ``python -m repro_torch.analysis [paths...]``.

Runs the port's lint rules over ``src/repro_torch`` (or the given paths)
and exits nonzero on findings not in the port's baseline,
``analysis_baseline_torch.json``. With ``--contracts`` it also runs the
contract auditor (on the card; ``--device cpu`` on the CPU) and folds its
verdict into the exit code. Exit codes: 0 clean, 1 findings or a contract
violation, 2 a path that does not exist.

    python -m repro_torch.analysis                   # lint, text report
    python -m repro_torch.analysis --json            # machine-readable
    python -m repro_torch.analysis --baseline        # diff vs the baseline
    python -m repro_torch.analysis --write-baseline  # burn current findings in
    python -m repro_torch.analysis --contracts --report AUDIT_contracts.json
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from repro_torch.analysis import engine
from repro_torch.analysis.rules import default_rules

DEFAULT_BASELINE = "analysis_baseline_torch.json"
DEFAULT_PATH = "src/repro_torch"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    ap.add_argument("paths", nargs="*", default=None,
                    help=f"files/dirs to lint (default: {DEFAULT_PATH}/)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit findings as JSON")
    ap.add_argument("--baseline", nargs="?", const=DEFAULT_BASELINE,
                    default=None, metavar="FILE",
                    help=f"only fail on findings absent from FILE "
                         f"(default {DEFAULT_BASELINE})")
    ap.add_argument("--write-baseline", nargs="?", const=DEFAULT_BASELINE,
                    default=None, metavar="FILE",
                    help="write current findings as the new baseline and exit 0")
    ap.add_argument("--contracts", action="store_true",
                    help="also run the contract audit (imports torch)")
    ap.add_argument("--device", default=None,
                    help="the audit's device (default: the CUDA card)")
    ap.add_argument("--report", default=None, metavar="FILE",
                    help="write the contract-audit JSON report to FILE")
    args = ap.parse_args(argv)

    root = Path.cwd()
    paths = [Path(p) for p in (args.paths or [DEFAULT_PATH])]
    missing = [p for p in paths if not p.exists()]
    if missing:
        print(f"analysis: no such path: {', '.join(map(str, missing))}",
              file=sys.stderr)
        return 2

    bad_files: list[Path] = []
    findings = engine.run_rules(paths, default_rules(), root=root,
                                on_error=bad_files.append)
    for p in bad_files:
        print(f"analysis: syntax error, skipped: {p}", file=sys.stderr)

    if args.write_baseline is not None:
        engine.write_baseline(Path(args.write_baseline), findings)
        print(f"analysis: wrote {len(findings)} finding(s) to "
              f"{args.write_baseline}")
        return 0

    if args.baseline is not None:
        baseline = engine.load_baseline(Path(args.baseline))
        findings = engine.new_findings(findings, baseline)

    print(engine.to_json(findings) if args.as_json
          else engine.to_text(findings))
    rc = 1 if findings else 0

    if args.contracts:
        from repro_torch.analysis import contracts
        report = contracts.run_audit(report_path=args.report,
                                     device=args.device)
        ok = report.get("ok", False)
        print(f"contracts: {'OK' if ok else 'VIOLATION'} — "
              f"{report.get('n_executables', 0)} executables, "
              f"{report.get('n_rebind_generations', 0)} rebind generations, "
              f"{report.get('n_tenant_interleavings', 0)} tenant "
              f"interleavings audited")
        if not ok:
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
