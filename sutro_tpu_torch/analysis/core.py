"""graftlint core: findings, suppressions, baseline, reports.

Engine-aware static analysis for this codebase. Three pass
families over a shared AST index:

- ``locks``    lock-order inversions, blocking calls under a lock,
               externally-supplied callbacks invoked under a lock,
               same-lock re-acquisition (non-reentrant deadlock)
- ``jitpure``  host-sync and nondeterminism inside device entry
               points (the trunk forward, CUDA kernel wrappers);
               wall-clock/nondeterminism in the scheduler's decode
               window
- ``hygiene``  threads that are neither daemon nor joined with a
               bounded timeout; silently swallowed exceptions
- ``resources`` path-sensitive acquire/release lifecycle over the
               engine's refcounted resources (pages, pins, channels,
               sockets, threads, slots)
- ``protocol`` dp/elastic wire-frame additivity vs the checked-in
               ``wire_schema.json``; unknown-key-tolerant parsing
- ``killswitch`` env-gated subsystems must gate side-effecting calls
               behind their flag (taint-walked from the env read)
- ``cardinality`` telemetry label values vs declared fixed-cardinality
               series budgets
- ``tracectx`` a bound forensics trace handle (``start_trace``) must be
               ended on every function exit path

Findings are fingerprinted by (rule, path, enclosing symbol, stable
detail key) — NOT by line number — so unrelated edits don't invalidate
the baseline. The committed baseline (``baseline.json``) holds a count
per fingerprint; the gate fails only on findings *exceeding* their
baselined count. Inline suppression::

    something_flagged()  # graftlint: disable=lock-blocking-call

(on the finding's line or the line above; comma-separate several rules,
or ``disable=all``.)
"""

from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

from .callgraph import PackageIndex

RULES = {
    "lock-order": "inconsistent pairwise lock acquisition order "
    "(deadlock risk)",
    "lock-reentrant": "non-reentrant lock re-acquired while already "
    "held on the same call path (self-deadlock)",
    "lock-blocking-call": "blocking call (I/O, sleep, join, socket) "
    "made while holding a lock",
    "lock-callback": "externally-supplied callback invoked while "
    "holding a lock",
    "jit-host-sync": "host-synchronizing operation reachable from a "
    "device entry point (the trunk forward or a CUDA kernel's wrapper)",
    "jit-nondeterminism": "wall clock or unseeded randomness inside a "
    "device entry point (the trunk forward or a CUDA kernel's wrapper)",
    "sched-nondeterminism": "wall clock or unseeded randomness in the "
    "scheduler decode window",
    "thread-unjoined": "thread is neither daemon nor joined",
    "thread-unbounded-join": "thread joined without a bounded timeout",
    "silent-except": "broad except swallows the exception without "
    "logging or re-raising",
    "unbounded-retry": "retry loop with no attempt/deadline bound or "
    "no (growing) backoff sleep between attempts",
    "resource-leak": "acquired resource (pages/pin/channel/socket/"
    "thread/slot) escapes a function exit path without its paired "
    "release",
    "resource-double-release": "resource released twice on one path "
    "(free-list / refcount corruption)",
    "wire-key-removed": "dp/elastic wire frame or key present in "
    "wire_schema.json is no longer produced (frames are strictly "
    "additive)",
    "wire-strict-parse": "frame parser rejects unknown keys instead "
    "of ignoring them (breaks protocol additivity)",
    "killswitch-ungated": "side-effecting call into an env-gated "
    "subsystem not dominated by its kill-switch flag check",
    "telemetry-cardinality": "metric label value outside the declared "
    "fixed-cardinality budget (or identifier-shaped)",
    "trace-ctx-dropped": "bound trace handle (start_trace) escapes a "
    "function exit path without end()/end_trace() — the trace stays "
    "unfinished in the forensics ring",
    "trace-ctx-double-end": "trace handle ended twice on one path",
    "shared-state-unlocked": "field reachable from two thread roots "
    "with a write that holds no lock and no happens-before edge "
    "(queue/event handoff, pre-start publication, bounded join)",
    "lockset-inconsistent": "field reachable from two thread roots "
    "whose accesses are each locked — but never by a common lock "
    "(empty lockset intersection)",
    "check-then-act": "value read from a field under a lock is used "
    "to write the field back after the lock was released and "
    "re-acquired (lost-update window)",
    "stale-suppression": "graftlint disable pragma that no longer "
    "masks any finding",
}

_SUPPRESS_RE = re.compile(
    r"#\s*graftlint:\s*disable=([A-Za-z0-9_,\- ]+)"
)


@dataclasses.dataclass
class Finding:
    rule: str
    path: str
    line: int
    message: str
    symbol: str = ""
    key: str = ""
    fp: Optional[str] = None  # explicit fingerprint override

    def fingerprint(self) -> str:
        if self.fp is not None:
            return self.fp
        return f"{self.rule}|{self.path}|{self.symbol}|{self.key}"

    def to_dict(self) -> Dict[str, object]:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "symbol": self.symbol,
            "message": self.message,
            "fingerprint": self.fingerprint(),
        }

    def render(self) -> str:
        where = f" [in {self.symbol}]" if self.symbol else ""
        return (
            f"{self.path}:{self.line}: {self.rule}{where} {self.message}"
        )


def pragma_map(lines: Sequence[str]) -> Dict[int, List[str]]:
    """1-based line -> rule tokens of ``# graftlint: disable=`` pragmas.

    Comments only (via ``tokenize``): a pragma *example* inside a
    docstring neither suppresses nor counts as stale. Falls back to a
    per-line regex when tokenization fails (syntactically odd input).
    """
    import io
    import tokenize

    src = "\n".join(lines)
    out: Dict[int, List[str]] = {}

    def record(lineno: int, text: str) -> None:
        m = _SUPPRESS_RE.search(text)
        if m:
            toks = [r.strip() for r in m.group(1).split(",") if r.strip()]
            if toks:
                out.setdefault(lineno, []).extend(toks)

    try:
        for tok in tokenize.generate_tokens(io.StringIO(src).readline):
            if tok.type == tokenize.COMMENT:
                record(tok.start[0], tok.string)
    except (tokenize.TokenError, IndentationError, SyntaxError):
        out.clear()
        for i, text in enumerate(lines, start=1):
            record(i, text)
    return out


def _index_pragmas(index: PackageIndex) -> Dict[str, Dict[int, List[str]]]:
    cache = getattr(index, "_graftlint_pragmas", None)
    if cache is None:
        cache = {
            m.path: pragma_map(m.lines) for m in index.modules.values()
        }
        index._graftlint_pragmas = cache  # type: ignore[attr-defined]
    return cache


def apply_suppressions(
    index: PackageIndex, findings: Iterable[Finding]
) -> "tuple[List[Finding], List[Finding]]":
    """Split findings into (active, suppressed) per inline pragmas (on
    the finding's line or the line above)."""
    active: List[Finding] = []
    suppressed: List[Finding] = []
    pragmas = _index_pragmas(index)
    for f in findings:
        per_path = pragmas.get(f.path, {})
        rules: set = set()
        for ln in (f.line, f.line - 1):
            rules.update(per_path.get(ln, ()))
        if "all" in rules or f.rule in rules:
            suppressed.append(f)
        else:
            active.append(f)
    return active, suppressed


def stale_suppression_findings(
    index: PackageIndex, suppressed: Sequence[Finding]
) -> List[Finding]:
    """Pragmas whose rule tokens masked nothing: each becomes a
    ``stale-suppression`` finding (suppressions must earn their keep,
    or the next real finding at that site is silently eaten)."""
    used: set = set()  # (path, pragma_line, rule_token)
    pragmas = _index_pragmas(index)
    for f in suppressed:
        per_path = pragmas.get(f.path, {})
        for ln in (f.line, f.line - 1):
            toks = per_path.get(ln, ())
            if f.rule in toks:
                used.add((f.path, ln, f.rule))
            elif "all" in toks:
                used.add((f.path, ln, "all"))
    out: List[Finding] = []
    mod_names = {m.path: m.name for m in index.modules.values()}
    for path, per_path in pragmas.items():
        for line, toks in per_path.items():
            for tok in toks:
                if (path, line, tok) in used:
                    continue
                why = (
                    "unknown rule"
                    if tok != "all" and tok not in RULES
                    else "masks no finding"
                )
                out.append(
                    Finding(
                        rule="stale-suppression",
                        path=path,
                        line=line,
                        message=f"suppression `disable={tok}` {why} — "
                        "remove it (dead pragmas silently eat the next "
                        "real finding here)",
                        symbol=mod_names.get(path, path),
                        key=tok,
                    )
                )
    return out


# -- scanning ----------------------------------------------------------


def build_index(paths: Sequence[str]) -> PackageIndex:
    index = PackageIndex()
    files: List[Path] = []
    for raw in paths:
        p = Path(raw)
        if p.is_dir():
            files.extend(sorted(p.rglob("*.py")))
        elif p.suffix == ".py":
            files.append(p)
    seen = set()
    for f in files:
        if "__pycache__" in f.parts:
            continue
        rp = f.as_posix()
        if rp in seen:
            continue
        seen.add(rp)
        index.add_file(f, rp)
    return index


def run_passes(
    index: PackageIndex, rules: Optional[Sequence[str]] = None
) -> List[Finding]:
    from . import (
        cardinality,
        hygiene,
        jitpure,
        killswitch,
        locks,
        protocol,
        races,
        resources,
        tracectx,
    )

    findings: List[Finding] = []
    findings.extend(locks.run(index))
    findings.extend(jitpure.run(index))
    findings.extend(hygiene.run(index))
    findings.extend(resources.run(index))
    findings.extend(protocol.run(index))
    findings.extend(killswitch.run(index))
    findings.extend(cardinality.run(index))
    findings.extend(tracectx.run(index))
    findings.extend(races.run(index))
    if rules:
        keep = set(rules)
        findings = [f for f in findings if f.rule in keep]
    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.key))
    return findings


def analyze(
    paths: Sequence[str], rules: Optional[Sequence[str]] = None
) -> "tuple[List[Finding], List[Finding], PackageIndex]":
    """Scan ``paths``; returns (active, suppressed, index)."""
    index = build_index(paths)
    findings = run_passes(index, rules)
    active, suppressed = apply_suppressions(index, findings)
    stale = stale_suppression_findings(index, suppressed)
    if rules:
        stale = [f for f in stale if f.rule in set(rules)]
    active.extend(stale)
    active.sort(key=lambda f: (f.path, f.line, f.rule, f.key))
    return active, suppressed, index


# -- baseline ----------------------------------------------------------

DEFAULT_BASELINE = Path(__file__).resolve().parent / "baseline.json"


def baseline_counts(findings: Iterable[Finding]) -> Dict[str, int]:
    counts: Dict[str, int] = {}
    for f in findings:
        counts[f.fingerprint()] = counts.get(f.fingerprint(), 0) + 1
    return counts


def write_baseline(path: Path, findings: Sequence[Finding]) -> None:
    payload = {
        "version": 1,
        "tool": "graftlint",
        "counts": dict(sorted(baseline_counts(findings).items())),
    }
    path.write_text(json.dumps(payload, indent=2) + "\n")


def load_baseline(path: Path) -> Dict[str, int]:
    data = json.loads(path.read_text())
    counts = data.get("counts", {})
    return {str(k): int(v) for k, v in counts.items()}


def compare_baseline(
    findings: Sequence[Finding], baseline: Dict[str, int]
) -> "tuple[List[Finding], Dict[str, int]]":
    """Returns (new_findings, stale) where ``new`` are findings beyond
    their baselined count and ``stale`` maps fingerprints whose current
    count dropped below baseline (fixed findings — regenerate)."""
    remaining = dict(baseline)
    new: List[Finding] = []
    for f in findings:
        fp = f.fingerprint()
        if remaining.get(fp, 0) > 0:
            remaining[fp] -= 1
        else:
            new.append(f)
    stale = {fp: n for fp, n in remaining.items() if n > 0}
    return new, stale


# -- reports -----------------------------------------------------------


def render_text(
    findings: Sequence[Finding],
    new: Optional[Sequence[Finding]] = None,
    stale: Optional[Dict[str, int]] = None,
    suppressed_count: int = 0,
) -> str:
    out: List[str] = []
    if new is None:
        for f in findings:
            out.append(f.render())
        out.append(
            f"graftlint: {len(findings)} finding(s), "
            f"{suppressed_count} suppressed"
        )
        return "\n".join(out)
    for f in new:
        out.append("NEW " + f.render())
    out.append(
        f"graftlint: {len(findings)} finding(s) "
        f"({len(new)} new vs baseline, {suppressed_count} suppressed)"
    )
    if stale:
        out.append(
            f"graftlint: {sum(stale.values())} baselined finding(s) no "
            "longer present — regenerate with --write-baseline"
        )
    return "\n".join(out)


def render_json(
    findings: Sequence[Finding],
    new: Optional[Sequence[Finding]] = None,
    stale: Optional[Dict[str, int]] = None,
    suppressed_count: int = 0,
) -> str:
    payload: Dict[str, object] = {
        "tool": "graftlint",
        "findings": [f.to_dict() for f in findings],
        "suppressed": suppressed_count,
    }
    if new is not None:
        payload["new"] = [f.to_dict() for f in new]
        payload["stale_baseline"] = stale or {}
    return json.dumps(payload, indent=2)


def render_sarif(findings: Sequence[Finding]) -> str:
    """SARIF 2.1.0 document for diff-annotation tooling (one run, one
    result per finding, fingerprints carried for dedupe)."""
    rules_seen = sorted({f.rule for f in findings})
    driver = {
        "name": "graftlint",
        "informationUri": "https://github.com/sutro-sh/sutro",
        "rules": [
            {
                "id": r,
                "shortDescription": {"text": RULES.get(r, r)},
            }
            for r in rules_seen
        ],
    }
    results = [
        {
            "ruleId": f.rule,
            "level": "error",
            "message": {"text": f.message},
            "partialFingerprints": {
                "graftlint/v1": f.fingerprint()
            },
            "locations": [
                {
                    "physicalLocation": {
                        "artifactLocation": {"uri": f.path},
                        "region": {"startLine": max(1, f.line)},
                    }
                }
            ],
        }
        for f in findings
    ]
    doc = {
        "$schema": "https://json.schemastore.org/sarif-2.1.0.json",
        "version": "2.1.0",
        "runs": [{"tool": {"driver": driver}, "results": results}],
    }
    return json.dumps(doc, indent=2)
