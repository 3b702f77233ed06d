"""Stage-graph wire frames: the NDJSON per-stage progress record.

The port of ``sutro_tpu/engine/stageframes.py``; its one transport call
(``_send``) posts with ``urllib`` rather than ``requests``.

A stage-graph job's progress stream carries one extra record type next
to the classic ``progress``/``tokens`` updates: a ``stage_progress``
frame with the conflated per-stage rollup (metrics bus ``stages``
channel -> ``GET /stream-job-progress``). The frame is strictly
additive, same contract as the fleet frames:

- Old SDK clients branch on ``update_type`` and ignore the ``t``/``v``
  discriminators; new clients get a typed frame.
- Plain (stage-less) jobs never publish on the ``stages`` channel, so
  their NDJSON byte stream is unchanged — the stage-graph off switch
  holds on the wire.
- Parsers use ``.get`` everywhere: a rollup entry from a newer engine
  with extra keys degrades to the fields this client understands,
  never an error.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional

#: protocol revision carried in every frame (additive: a reader never
#: rejects a frame over ``v`` — it only gates optional features)
STAGE_WIRE_V = 1


# -- send-side frame constructors (the schema source of truth) ---------


def stage_progress_frame(stages: Dict[str, Any]) -> Dict[str, Any]:
    """Engine -> client: conflated per-stage rollup, one entry per
    stage name: ``{status, kind, rows_done, rows_total, quarantined}``.
    ``update_type`` keeps the record consumable by pre-stage-graph
    NDJSON readers (they see an unknown update_type and skip)."""
    return {
        "t": "stage_progress",
        "v": STAGE_WIRE_V,
        "update_type": "stages",
        "result": dict(stages),
    }


# -- recv-side tolerant parsers ----------------------------------------


def parse_stage_progress(doc: Any) -> Optional[Dict[str, Any]]:
    """Tolerant read of a ``stage_progress`` frame (or a bare legacy
    ``{"update_type": "stages"}`` record). Returns the rollup dict, or
    None when the document is not a stage record."""
    if not isinstance(doc, dict):
        return None
    if doc.get("t") not in (None, "stage_progress"):
        return None
    if doc.get("update_type") != "stages":
        return None
    result = doc.get("result")
    return dict(result) if isinstance(result, dict) else {}


def rollup_counts(entry: Any) -> Dict[str, Any]:
    """Normalize one stage's rollup entry for display: unknown fields
    from a newer engine are dropped, missing ones default."""
    if not isinstance(entry, dict):
        entry = {}

    def _int(key: str) -> int:
        try:
            return max(0, int(entry.get(key) or 0))
        except (TypeError, ValueError):
            return 0

    return {
        "status": str(entry.get("status") or "pending"),
        "kind": str(entry.get("kind") or "map"),
        "rows_done": _int("rows_done"),
        "rows_total": _int("rows_total"),
        "quarantined": _int("quarantined"),
    }


# -- transport ---------------------------------------------------------


def _send(
    url: str,
    payload: Dict[str, Any],
    timeout: float = 30.0,
) -> Any:
    """One client->daemon stage-graph submit (``POST
    /batch-inference`` with a ``stages`` payload); returns the decoded
    JSON document with the HTTP status attached. Non-2xx is a protocol
    answer (400 ``INVALID_GRAPH`` carries the structured error body),
    not a transport error — callers branch on ``_status`` without
    exceptions, same failure taxonomy as the fleet frames."""
    from urllib.error import HTTPError
    from urllib.request import Request, urlopen

    req = Request(
        url, data=json.dumps(payload).encode(), method="POST",
        headers={"Content-Type": "application/json"},
    )
    try:
        with urlopen(req, timeout=timeout) as resp:
            status, body = resp.status, resp.read()
    except HTTPError as e:
        status, body = e.code, e.read()
    try:
        doc = json.loads(body)
    except ValueError:
        doc = {}
    if isinstance(doc, dict):
        doc.setdefault("_status", status)
    return doc
