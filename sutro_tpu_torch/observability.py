"""Observability: optional LangSmith tracing of SDK calls.

The part of ``sutro_tpu/observability.py`` that the SDK calls:

- activation via env ``LANGSMITH_TRACING=true`` when the ``langsmith``
  package is installed (it is optional: without it every hook is a
  no-op), project from ``LANGSMITH_PROJECT``;
- online path: ``_traced_run`` wraps a call in an LLM-type run;
- batch path: one top-level trace per row with deterministic
  ``uuid5(NS, f"{job_id}-{row_index}")`` ids, so create/complete works
  two-phase without local state;
- all trace failures reduce to warnings.

``langsmith`` is imported only once tracing is switched on.

``profile_trace`` captures a ``torch.profiler`` trace around a block
when ``SUTRO_PROFILE=1`` (the JAX package's goes through
``jax.profiler``).
"""

from __future__ import annotations

import contextlib
import importlib.util
import logging
import os
import uuid
from datetime import datetime, timezone
from typing import Any, Callable, Dict, List, Optional

logger = logging.getLogger("sutro.observability")

_NAMESPACE = uuid.UUID("f47ac10b-58cc-4372-a567-0e02b2c3d479")


def tracing_enabled() -> bool:
    return (
        os.environ.get("LANGSMITH_TRACING", "").lower() == "true"
        and importlib.util.find_spec("langsmith") is not None
    )


def _project() -> str:
    return os.environ.get("LANGSMITH_PROJECT", "default")


def run_id_for_row(job_id: str, row_index: int) -> uuid.UUID:
    """Deterministic per-row run id."""
    return uuid.uuid5(_NAMESPACE, f"{job_id}-{row_index}")


def _traced_run(
    name: str,
    fn: Callable[[], Any],
    *,
    inputs: Optional[Dict[str, Any]] = None,
) -> Any:
    """Run ``fn`` inside an LLM-type traced run when tracing is active
    (``inputs`` as the JAX package's signature has it; the run records
    ``fn``'s own inputs)."""
    if not tracing_enabled():
        return fn()
    try:  # pragma: no cover - needs langsmith
        from langsmith.run_helpers import traceable

        @traceable(run_type="llm", name=name, project_name=_project())
        def _call():
            return fn()

        return _call()
    except Exception as e:
        logger.warning("LangSmith tracing failed: %s", e)
        return fn()


def _create_batch_traces(
    job_id: str,
    inputs: List[Any],
    model: str,
) -> None:
    """One open run per row at submit time."""
    if not tracing_enabled():
        return
    try:  # pragma: no cover
        import langsmith

        client = langsmith.Client()
        runs = [
            {
                "id": str(run_id_for_row(job_id, i)),
                "name": f"sutro-batch-{job_id}",
                "run_type": "llm",
                "inputs": {"input": row},
                "extra": {"metadata": {"sutro_job_id": job_id, "model": model}},
                "session_name": _project(),
            }
            for i, row in enumerate(inputs)
        ]
        client.batch_ingest_runs(create=runs)
    except Exception as e:
        logger.warning("batch trace create failed: %s", e)


def _has_open_batch_traces(job_id: str) -> bool:
    """Probe row 0's end_time."""
    if not tracing_enabled():
        return False
    try:  # pragma: no cover
        import langsmith

        run = langsmith.Client().read_run(str(run_id_for_row(job_id, 0)))
        return run.end_time is None
    except Exception:
        return False


def _complete_batch_traces(
    job_id: str,
    outputs: List[Any],
    input_tokens: int,
    output_tokens: int,
) -> None:
    """Close per-row runs with outputs + per-row token estimates
    (= totals // num_rows)."""
    if not tracing_enabled():
        return
    try:  # pragma: no cover
        import langsmith

        client = langsmith.Client()
        n = max(len(outputs), 1)
        updates = [
            {
                "id": str(run_id_for_row(job_id, i)),
                "outputs": {"output": out},
                "extra": {
                    "metadata": {
                        "usage_metadata": {
                            "input_tokens": input_tokens // n,
                            "output_tokens": output_tokens // n,
                        }
                    }
                },
                "end_time": datetime.now(timezone.utc),
            }
            for i, out in enumerate(outputs)
        ]
        client.batch_ingest_runs(update=updates)
    except Exception as e:
        logger.warning("batch trace complete failed: %s", e)


# ---------------------------------------------------------------------------
# Engine-level profiling
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def profile_trace(out_dir: Optional[str] = None):
    """Capture a ``torch.profiler`` trace around a block when
    ``SUTRO_PROFILE=1``, exported as Chrome trace-event JSON (Perfetto
    or ``chrome://tracing``) to ``{out_dir}/trace-<pid>-<unix ms>.json``
    (``out_dir`` defaults to ``$SUTRO_HOME/profiles``). The card's
    kernels are recorded when a card is present; the CPU's ops always
    (on this thread)."""
    if os.environ.get("SUTRO_PROFILE") != "1":
        yield
        return
    import time

    import torch

    from .engine.config import sutro_home
    from .engine.profiling import _start

    out = out_dir or str(sutro_home() / "profiles")
    os.makedirs(out, exist_ok=True)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    path = os.path.join(
        out, "trace-%d-%d.json" % (os.getpid(), int(time.time() * 1e3))
    )
    prof = _start(path, device)
    try:
        yield
    finally:
        prof.stop()
    prof.export_chrome_trace(path)
    logger.info("profile trace written to %s", path)
