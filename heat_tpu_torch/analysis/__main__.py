"""heatlint CLI for the port: ``python -m heat_tpu_torch.analysis [paths...]``.

Exit codes: 0 = clean (suppressed and baseline-grandfathered findings are
fine), 1 = new findings (the gate), 2 = usage error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from . import (
    BASELINE_NAME,
    DEFAULT_PATHS,
    RULES,
    analyze,
    apply_baseline,
    load_baseline,
    load_baseline_entries,
    repo_root,
    write_baseline,
)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m heat_tpu_torch.analysis",
        description="heatlint: static enforcement of the port's dispatch, "
        "collective, precision, and knob invariants",
    )
    p.add_argument("paths", nargs="*",
                   help=f"files/dirs to scan (default: {' '.join(DEFAULT_PATHS)})")
    p.add_argument("--root", default=None,
                   help="repo root for path normalization and the default "
                        "baseline (default: the checkout containing heat_tpu_torch)")
    p.add_argument("--baseline", default=None, metavar="FILE",
                   help=f"baseline file (default: <root>/{BASELINE_NAME} "
                        "when present)")
    p.add_argument("--no-baseline", action="store_true",
                   help="ignore any baseline: report every finding as new")
    p.add_argument("--write-baseline", action="store_true",
                   help="grandfather every current finding into the "
                        "baseline file and exit 0")
    p.add_argument("--select", default=None, metavar="HL001,HL002",
                   help="comma-separated rule subset")
    p.add_argument("--format", choices=("text", "json"), default="text")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule catalog and exit")
    p.add_argument("--knob-table", action="store_true",
                   help="print the knob table (_knobs.markdown_table()) and exit")
    args = p.parse_args(argv)

    if args.knob_table:
        from .. import _knobs as knobs

        print(knobs.markdown_table(), end="")
        return 0
    if args.list_rules:
        for r in RULES:
            print(f"{r.id}  {r.title}")
            print(f"       {r.rationale}")
            if r.allowed:
                print(f"       allowed: {', '.join(sorted(r.allowed))}")
        return 0

    root = os.path.abspath(args.root) if args.root else repo_root()
    paths = args.paths or [
        pth for pth in DEFAULT_PATHS if os.path.exists(os.path.join(root, pth))
    ]
    select = args.select.split(",") if args.select else None
    try:
        report = analyze(paths, root, select=select)
    except (FileNotFoundError, ValueError) as e:
        print(str(e), file=sys.stderr)
        return 2

    baseline_path = args.baseline or os.path.join(root, BASELINE_NAME)
    if args.write_baseline:
        # a narrowed run (explicit paths / --select) re-grandfathers only
        # what it scanned; entries outside that scope are preserved, not
        # silently dropped
        preserved = []
        if not args.no_baseline and os.path.exists(baseline_path):
            scanned = set(report.scanned_paths)
            selected = (
                {s.strip().upper() for s in select}
                if select else {r.id for r in RULES}
            )
            preserved = [
                e for e in load_baseline_entries(baseline_path)
                if e["path"] not in scanned or e["rule"] not in selected
            ]
        write_baseline(report, baseline_path, preserved=preserved)
        kept = f" (+{len(preserved)} out-of-scope preserved)" if preserved else ""
        print(
            f"heatlint: wrote {len(report.findings) + len(report.baselined)} "
            f"grandfathered finding(s){kept} to {baseline_path}"
        )
        return 0
    if not args.no_baseline and os.path.exists(baseline_path):
        report = apply_baseline(report, load_baseline(baseline_path))

    counts = report.counts()
    if args.format == "json":
        print(json.dumps({
            **counts,
            "findings": [f.to_json() for f in report.findings],
            "baselined": [f.to_json() for f in report.baselined],
            "suppressed": [
                {**f.to_json(), "reason": reason}
                for f, reason in report.suppressed
            ],
        }))
    else:
        for f in report.findings:
            print(f.render())
        print(
            f"heatlint: scanned {counts['files']} files — "
            f"{counts['new']} new finding(s), {counts['baselined']} "
            f"baseline-grandfathered, {counts['suppressed']} suppressed "
            f"inline"
        )
        if report.findings:
            print(
                "fix the finding, or suppress one deliberate site with "
                "'# heatlint: disable=<rule> -- <reason>'",
            )
    return 1 if report.findings else 0


if __name__ == "__main__":
    sys.exit(main())
