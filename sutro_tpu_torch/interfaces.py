"""Client protocol and job state machine.

A copy of ``sutro_tpu/interfaces.py`` (the port keeps its own copy of
what it needs from the JAX package): the ``JobStatus`` state machine and
the ``BaseSutroClient`` protocol that the task-template mixins type-check
against. States match the Sutro SDK's lifecycle, so user code observing
job status ports over unchanged.
"""

from __future__ import annotations

from enum import Enum
from typing import Any, Dict, List, Optional, Protocol, Union, runtime_checkable


class JobStatus(str, Enum):
    """Lifecycle states of a batch-inference job.

    Mirrors the reference state machine (interfaces.py:69-91). Here these
    states are driven by the in-process engine scheduler rather than a
    remote service:

    - QUEUED:     accepted by the jobstore, waiting for an engine slot
    - STARTING:   weights loading / compile in flight
    - RUNNING:    rows being prefilled/decoded
    - SUCCEEDED:  all rows finished; results visible (invariant: results are
                  written to the jobstore *before* the state flips — see
                  engine/jobstore.py — which deletes the reference's
                  results-availability race, sdk.py:384-401)
    - FAILED:     terminal failure; ``failure_reason`` is populated
    - CANCELLING: cancel requested, engine draining
    - CANCELLED:  terminal cancel
    """

    QUEUED = "QUEUED"
    STARTING = "STARTING"
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    CANCELLING = "CANCELLING"
    CANCELLED = "CANCELLED"
    # Local-engine extra: job record exists but its results were evicted.
    UNAVAILABLE = "UNAVAILABLE"

    def is_terminal(self) -> bool:
        """Terminal set matches the reference (interfaces.py:81-88)."""
        return self in (
            JobStatus.SUCCEEDED,
            JobStatus.FAILED,
            JobStatus.CANCELLING,
            JobStatus.CANCELLED,
        )

    def is_active(self) -> bool:
        return self in (JobStatus.QUEUED, JobStatus.STARTING, JobStatus.RUNNING)


@runtime_checkable
class BaseSutroClient(Protocol):
    """Structural type for the client core, used by template mixins.

    The template mixins (templates/*.py) are mixed into ``Sutro`` via MRO and
    call back into the client through this protocol (reference
    interfaces.py:11-66).
    """

    def infer(
        self,
        data: Any,
        model: str = "qwen-3-4b",
        column: Optional[Union[str, List[str]]] = None,
        output_column: str = "inference_result",
        job_priority: int = 0,
        output_schema: Optional[Any] = None,
        system_prompt: Optional[str] = None,
        name: Optional[str] = None,
        description: Optional[str] = None,
        dry_run: bool = False,
        stay_attached: Optional[bool] = None,
        truncate_rows: bool = True,
        random_seed_per_input: bool = False,
        sampling_params: Optional[Dict[str, Any]] = None,
    ) -> Any:
        ...

    def run_graph(
        self,
        data: Any,
        stages: List[Dict[str, Any]],
        model: str = "qwen-3-4b",
        column: Optional[Union[str, List[str]]] = None,
        output_column: str = "inference_result",
        job_priority: int = 0,
        name: Optional[str] = None,
        description: Optional[str] = None,
        dry_run: bool = False,
        stay_attached: Optional[bool] = None,
        truncate_rows: bool = True,
        sampling_params: Optional[Dict[str, Any]] = None,
        tenant: Optional[str] = None,
    ) -> Any:
        ...

    def await_job_completion(
        self,
        job_id: str,
        timeout: int = 7200,
        obtain_results: bool = True,
        output_column: str = "inference_result",
        unpack_json: bool = True,
        with_original_df: Optional[Any] = None,
    ) -> Any:
        ...

    def get_job_results(
        self,
        job_id: str,
        include_inputs: bool = False,
        include_cumulative_logprobs: bool = False,
        output_column: str = "inference_result",
        unpack_json: bool = True,
        with_original_df: Optional[Any] = None,
        disable_cache: bool = False,
    ) -> Any:
        ...
