"""graftlint CLI: ``python -m sutro_tpu_torch.analysis [paths...]``.

Exit codes: 0 clean (vs baseline unless ``--no-baseline``), 1 new
findings, 2 usage/internal error.

``--diff <git-ref>`` restricts the report to findings on lines changed
vs the ref (fast pre-commit gate); ``--write-wire-schema`` regenerates
``analysis/wire_schema.json`` from the current senders (``make
lint-schema`` wraps it with an uncommitted-drift check);
``--format sarif`` emits SARIF 2.1.0 for code-scanning upload;
``--threads`` dumps the thread-root inventory the data-race pass
analyzes over.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
from pathlib import Path
from typing import Dict, Set

from . import core, protocol

_HUNK_RE = re.compile(r"^@@ -\d+(?:,\d+)? \+(\d+)(?:,(\d+))? @@")


def changed_lines(ref: str) -> Dict[str, Set[int]]:
    """Repo-root-relative path -> 1-based added/changed line numbers in
    the working tree vs ``ref`` (zero-context unified diff)."""
    root = subprocess.run(
        ["git", "rev-parse", "--show-toplevel"],
        capture_output=True,
        text=True,
        check=True,
    ).stdout.strip()
    diff = subprocess.run(
        ["git", "-C", root, "diff", "--unified=0", ref, "--", "*.py"],
        capture_output=True,
        text=True,
        check=True,
    ).stdout
    out: Dict[str, Set[int]] = {}
    cur: Set[int] = set()
    for line in diff.splitlines():
        if line.startswith("+++ "):
            name = line[4:].strip()
            if name.startswith("b/"):
                name = name[2:]
            cur = out.setdefault(name, set()) if name != "/dev/null" else set()
        else:
            m = _HUNK_RE.match(line)
            if m:
                start = int(m.group(1))
                count = int(m.group(2)) if m.group(2) is not None else 1
                cur.update(range(start, start + count))
    return out


def _to_root_rel(path: str) -> str:
    try:
        root = subprocess.run(
            ["git", "rev-parse", "--show-toplevel"],
            capture_output=True,
            text=True,
            check=True,
        ).stdout.strip()
        return Path(path).resolve().relative_to(Path(root)).as_posix()
    except (subprocess.CalledProcessError, ValueError, OSError):
        return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sutro_tpu_torch.analysis",
        description=(
            "graftlint: engine-aware static analysis (lock discipline, "
            "device entry-point purity, thread/exception hygiene)"
        ),
    )
    ap.add_argument(
        "paths",
        nargs="*",
        default=["sutro_tpu_torch"],
        help="files or directories to scan (default: sutro_tpu_torch)",
    )
    ap.add_argument(
        "--format", choices=("text", "json", "sarif"), default="text"
    )
    ap.add_argument(
        "--threads",
        action="store_true",
        help="print the thread-root inventory (every Thread/Timer "
        "spawn site with its resolved target) and exit 0",
    )
    ap.add_argument(
        "--baseline",
        default=str(core.DEFAULT_BASELINE),
        help="baseline file (default: sutro_tpu_torch/analysis/baseline.json)",
    )
    ap.add_argument(
        "--no-baseline",
        action="store_true",
        help="report every finding; exit 1 if any",
    )
    ap.add_argument(
        "--write-baseline",
        action="store_true",
        help="write the current findings as the new baseline and exit 0",
    )
    ap.add_argument(
        "--rules",
        default="",
        help="comma-separated rule subset (default: all)",
    )
    ap.add_argument(
        "--list-rules", action="store_true", help="print the rule catalog"
    )
    ap.add_argument(
        "--diff",
        metavar="GIT_REF",
        default=None,
        help="report only findings on lines changed vs GIT_REF "
        "(ignores the baseline; exit 1 if any)",
    )
    ap.add_argument(
        "--write-wire-schema",
        action="store_true",
        help="regenerate analysis/wire_schema.json from the current "
        "dp/elastic senders and exit 0",
    )
    ap.add_argument(
        "-v",
        "--verbose",
        action="store_true",
        help="also print baselined (non-new) findings",
    )
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule, desc in sorted(core.RULES.items()):
            print(f"{rule:24s} {desc}")
        return 0

    rules = [r.strip() for r in args.rules.split(",") if r.strip()]
    for r in rules:
        if r not in core.RULES:
            print(f"graftlint: unknown rule {r!r}", file=sys.stderr)
            return 2
    paths = args.paths or ["sutro_tpu_torch"]
    for p in paths:
        if not Path(p).exists():
            print(f"graftlint: no such path {p!r}", file=sys.stderr)
            return 2

    if args.threads:
        # inventory needs only the index, not the finding passes
        from . import races

        try:
            roots = races.inventory(core.build_index(paths))
        except SyntaxError as e:
            print(f"graftlint: parse error: {e}", file=sys.stderr)
            return 2
        for root in roots:
            print(root.describe())
        print(f"graftlint: {len(roots)} thread root(s)")
        return 0

    try:
        active, suppressed, index = core.analyze(paths, rules or None)
    except SyntaxError as e:
        print(f"graftlint: parse error: {e}", file=sys.stderr)
        return 2

    if args.write_wire_schema:
        doc = protocol.write_schema(index)
        print(
            f"graftlint: wrote {len(doc['frames'])} frame type(s) to "
            f"{protocol.DEFAULT_SCHEMA_PATH}"
        )
        return 0

    if args.diff is not None:
        try:
            changed = changed_lines(args.diff)
        except (subprocess.CalledProcessError, OSError) as e:
            print(f"graftlint: git diff failed: {e}", file=sys.stderr)
            return 2
        hits = [
            f
            for f in active
            if f.line in changed.get(_to_root_rel(f.path), ())
        ]
        if args.format == "json":
            print(core.render_json(hits, suppressed_count=len(suppressed)))
        elif args.format == "sarif":
            print(core.render_sarif(hits))
        else:
            for f in hits:
                print(f.render())
            print(
                f"graftlint: {len(hits)} finding(s) on lines changed "
                f"vs {args.diff}"
            )
        return 1 if hits else 0

    baseline_path = Path(args.baseline)
    if args.write_baseline:
        core.write_baseline(baseline_path, active)
        print(
            f"graftlint: wrote {len(active)} finding(s) to "
            f"{baseline_path}"
        )
        return 0

    if args.no_baseline or not baseline_path.exists():
        if args.format == "json":
            print(
                core.render_json(
                    active, suppressed_count=len(suppressed)
                )
            )
        elif args.format == "sarif":
            print(core.render_sarif(active))
        else:
            print(
                core.render_text(
                    active, suppressed_count=len(suppressed)
                )
            )
        if not args.no_baseline and not baseline_path.exists():
            print(
                f"graftlint: no baseline at {baseline_path} "
                "(create one with --write-baseline)",
                file=sys.stderr,
            )
        return 1 if active else 0

    baseline = core.load_baseline(baseline_path)
    new, stale = core.compare_baseline(active, baseline)
    if args.format == "json":
        print(
            core.render_json(
                active if args.verbose else new,
                new=new,
                stale=stale,
                suppressed_count=len(suppressed),
            )
        )
    elif args.format == "sarif":
        print(core.render_sarif(active if args.verbose else new))
    else:
        if args.verbose:
            for f in active:
                print(f.render())
        print(
            core.render_text(
                active,
                new=new,
                stale=stale,
                suppressed_count=len(suppressed),
            )
        )
    return 1 if new else 0


if __name__ == "__main__":
    raise SystemExit(main())
