"""CLI: ``python -m vainplex_openclaw_tpu_torch.analysis [--root R] [--only P]
[--json [PATH]]``.

The port's gates over the port's tree (``--root`` must hold
``vainplex_openclaw_tpu_torch/``). Exit codes: 0 clean (baselined findings
allowed), 1 active findings, 2 analyzer crash — a caller treats anything
but 0 as a failure and greps the per-gate summary lines (``graftlint:``
/ ``tracelint:`` / ``protolint:``), so a crashing analyzer can never read
as a passing gate. ``chip_smoke.py``'s analysis phase runs it so.

``--only`` takes rule-id prefixes (repeatable or comma-separated) and runs
only the matching families — the seam that lets one slow family (the
GL-PROTO-SCHED interleaving explorer) run or be skipped independently of
the fast AST lints. ``--json`` bare prints the machine-readable report on
stdout; ``--json PATH`` writes it to PATH (the CI findings artifact) while
keeping the human output on stdout.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="graftlint")
    parser.add_argument("--root", default=".",
                        help="repo root (default: cwd)")
    parser.add_argument("--baseline", default=None,
                        help="baseline file (default: the checked-in one)")
    parser.add_argument("--only", action="append", default=None,
                        metavar="RULE_PREFIX",
                        help="run only rule families matching this prefix "
                             "(repeatable, comma-separated; e.g. "
                             "--only GL-PROTO-SCHED runs just the "
                             "interleaving explorer, --only GL-LOCK,GL-PROTO-E"
                             " skips it)")
    parser.add_argument("--json", nargs="?", const="-", default=None,
                        metavar="PATH",
                        help="machine-readable report: bare/'-' on stdout, "
                             "PATH writes the CI findings artifact and keeps "
                             "the human summary on stdout")
    args = parser.parse_args(argv)

    root = Path(args.root)
    if not (root / "vainplex_openclaw_tpu_torch").is_dir():
        print(f"graftlint: no package under {root}", file=sys.stderr)
        return 2

    only = None
    if args.only:
        only = [p.strip() for arg in args.only for p in arg.split(",")
                if p.strip()] or None

    from . import run_analysis
    report = run_analysis(root, args.baseline, only=only)

    if args.json == "-":
        print(json.dumps(report.to_dict(), indent=2, sort_keys=True))
        return 0 if report.ok else 1
    if args.json is not None:
        Path(args.json).write_text(
            json.dumps(report.to_dict(), indent=2, sort_keys=True),
            encoding="utf-8")
    for finding in report.active:
        print(finding.render())
    for finding, rationale in report.suppressed:
        print(f"{finding.render()}  [baselined: {rationale}]",
              file=sys.stderr)
    for key in report.stale_keys:
        print(f"stale baseline entry (fixed? delete it): {key}",
              file=sys.stderr)
    print(report.summary())
    return 0 if report.ok else 1


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as exc:  # noqa: BLE001 — crash must exit 2, visibly
        print(f"graftlint: analyzer crashed: {exc!r}", file=sys.stderr)
        raise SystemExit(2)
