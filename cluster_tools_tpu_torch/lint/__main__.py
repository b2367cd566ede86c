"""``python -m cluster_tools_tpu_torch.lint`` — run ctlint and exit 1 on findings.

Usage::

    python -m cluster_tools_tpu_torch.lint                  # lint the port
    python -m cluster_tools_tpu_torch.lint path/ file.py    # lint specific paths
    python -m cluster_tools_tpu_torch.lint --json           # machine-readable
    python -m cluster_tools_tpu_torch.lint --rules CT002,CT006
    python -m cluster_tools_tpu_torch.lint --list-rules

With no paths, lints the ``cluster_tools_tpu_torch`` package plus the
repo's ``scripts/torch_*.py`` and ``chip_smoke.py`` when they exist next to
it.  Exit codes: 0 clean, 1 findings, 2 an unknown rule id.  Render a saved
``--json`` document with ``scripts/failures_report.py --lint``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .core import findings_to_json, run_lint
from .rules import RULES


def default_paths() -> list:
    """The package itself + the repo's ``scripts/torch_*.py`` and
    ``chip_smoke.py`` when present."""
    pkg_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    repo_root = os.path.dirname(pkg_dir)
    paths = [pkg_dir]
    scripts = os.path.join(repo_root, "scripts")
    if os.path.isdir(scripts):
        paths += [
            os.path.join(scripts, f) for f in sorted(os.listdir(scripts))
            if f.startswith("torch_") and f.endswith(".py")
        ]
    smoke = os.path.join(repo_root, "chip_smoke.py")
    if os.path.exists(smoke):
        paths.append(smoke)
    return paths


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="cluster_tools_tpu_torch.lint",
        description="repo-native static analysis of the port (docs/ANALYSIS.md)",
    )
    p.add_argument("paths", nargs="*", help="files/dirs (default: the port)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="emit the findings document as JSON on stdout")
    p.add_argument("--rules", default=None,
                   help="comma-separated rule ids to run (default: all)")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule ids + one-line summaries and exit")
    args = p.parse_args(argv)

    if args.list_rules:
        for rule_id, fn in sorted(RULES.items()):
            doc = (fn.__doc__ or "").strip().splitlines()
            print(f"{rule_id}  {doc[0] if doc else ''}")
        return 0

    select = None
    if args.rules:
        select = [r.strip() for r in args.rules.split(",") if r.strip()]
    paths = args.paths or default_paths()
    try:
        findings, stats = run_lint(paths, select=select)
    except ValueError as e:
        print(f"ctlint: {e}", file=sys.stderr)
        return 2

    if args.as_json:
        print(json.dumps(findings_to_json(findings, stats), indent=2))
    else:
        for f in findings:
            print(f.render())
        n = len(findings)
        print(
            f"ctlint: {n} finding(s) in {stats['n_files']} file(s)"
            + (f", {stats['n_suppressed']} suppressed"
               if stats["n_suppressed"] else "")
        )
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
