"""Stage-graph wire frames: the NDJSON per-stage progress record.

The one piece of ``sutro_tpu/engine/stageframes.py`` the port needs:
``metrics.JobMetrics.subscribe`` emits a ``stage_progress`` frame when a
job publishes per-stage counters. Plain (stage-less) jobs never publish
on that channel, so their progress stream carries only ``progress`` and
``tokens`` updates; stage graphs themselves are not ported (ROADMAP).
"""

from __future__ import annotations

from typing import Any, Dict

#: protocol revision carried in every frame (additive: a reader never
#: rejects a frame over ``v`` — it only gates optional features)
STAGE_WIRE_V = 1


def stage_progress_frame(stages: Dict[str, Any]) -> Dict[str, Any]:
    """Engine -> client: conflated per-stage rollup, one entry per
    stage name: ``{status, kind, rows_done, rows_total, quarantined}``.
    ``update_type`` keeps the record consumable by readers that predate
    stage graphs (they see an unknown update_type and skip)."""
    return {
        "t": "stage_progress",
        "v": STAGE_WIRE_V,
        "update_type": "stages",
        "result": dict(stages),
    }
