"""Command-line entry point: ``python -m spjoin_lint_torch [paths...]``.

Exit status 0 means every contract holds; 1 means violations, printed one
per line as ``file:line: [rule] message``. ``--audit`` also runs the
run-time audit (imports torch and the port); ``--json`` prints the
violations as one JSON list instead.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def _repo_root() -> str:
    # tools/spjoin_lint_torch/cli.py -> the repository root is two levels up.
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="spjoin-lint-torch",
        description="Contract checker of the PyTorch/CUDA port: AST rules + run-time audit.",
    )
    parser.add_argument("paths", nargs="*", default=None,
                        help="files or directories to lint (default: <repo>/src/repro_torch)")
    parser.add_argument("--audit", action="store_true",
                        help="also run the run-time audit (imports torch and repro_torch)")
    parser.add_argument("--json", action="store_true",
                        help="print the AST layer's violations as one JSON list")
    args = parser.parse_args(argv)

    root = _repo_root()
    paths = args.paths or [os.path.join(root, "src", "repro_torch")]

    from spjoin_lint_torch.astlint import iter_lint_files, lint_paths

    violations, n_waivers = lint_paths(paths)
    if args.json:
        print(json.dumps([{"file": v.file, "line": v.line, "rule": v.rule, "message": v.message}
                          for v in violations]))
    else:
        for v in violations:
            print(v.format())
        print(f"spjoin-lint-torch [ast]: {len(violations)} violation(s) across "
              f"{len(iter_lint_files(paths))} file(s) in scope ({n_waivers} waiver(s) in use)")
    failed = bool(violations)

    if args.audit:
        src = os.path.join(root, "src")
        if os.path.isdir(src) and src not in sys.path:
            sys.path.insert(0, src)
        from spjoin_lint_torch.audit import run_audit

        report, problems = run_audit()
        for p in problems:
            print(f"contracts: {p}")
        print(f"spjoin-lint-torch [audit]: {len(report['f64'])} op call(s) and {len(report['stages'])} "
              f"stage call(s) audited, {len(problems)} problem(s)")
        failed |= bool(problems)

    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
