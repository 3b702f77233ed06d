"""The ``Sutro`` client: DataFrame-in/DataFrame-out batch inference.

The port of ``sutro_tpu/sdk.py``. ``backend="tpu"`` (the default; the
name is the SDK's) runs jobs on the in-process ``LocalEngine`` of
``engine/api.py`` on a CUDA card; ``backend="remote"`` (or ``"fleet"``,
the same transport) sends the same calls over HTTP to a server
(``python -m sutro_tpu_torch.server``, or the JAX package's) at
``base_url``. The transport is the standard library's ``urllib``
(``do_request``; the card's machine has no ``requests``): it answers
with a small response object (``status_code``, ``json()``,
``content``, ``text``, ``iter_lines()``, ``raise_for_status()``).

No third-party package is imported at module level: pandas only in the
methods that build or read a DataFrame (``get_job_results`` and what
calls it), tqdm only in the progress bar (``common.fancy_tqdm``). A
list, a ``dataset-<id>`` or a URL in, ``stay_attached=False`` and
``engine.job_results`` out is a path that needs neither. The results
cache holds the same columns as the JAX package's parquet cache, as
JSON (``$SUTRO_HOME/job-results/<job_id>.json``).

``chat`` sends one OpenAI chat request to the interactive tier: the
engine's gateway locally (``engine_config={"interactive_slots": N}``),
``POST /v1/chat/completions`` remotely.

``run_graph`` submits a stage graph (``engine/stagegraph.py``) as one
job; ``get_monitor`` reads the live SLO monitor, locally or over HTTP.

``get_fleet``, ``get_fleet_monitor`` and ``get_replay_log`` read a fleet
router (``fleet/router.py``; ``backend="fleet"``).

``get_job_fleet`` reads a data-parallel job's fleet view
(``engine/dphost.py``), locally or as ``GET /job-fleet/{id}``.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import sys
import time
import urllib.error
import urllib.request
import uuid
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

from .common import (
    ModelOptions,
    Spinner,
    fancy_tqdm,
    human_bytes,
    make_clickable_link,
    normalize_output_schema,
    prepare_input_data,
    to_colored_text,
)
from .interfaces import JobStatus
from .observability import (
    _complete_batch_traces,
    _create_batch_traces,
    _has_open_batch_traces,
    _traced_run,
    tracing_enabled,
)
from .templates.classification import ClassificationTemplates
from .templates.embed import EmbeddingTemplates
from .templates.evals import EvalTemplates
from .validation import check_for_api_key, check_version, config_dir

MAX_NAME_LENGTH = 45
MAX_DESCRIPTION_LENGTH = 512
DEFAULT_BASE_URL = "https://api.sutro.sh"
DEFAULT_SERVING_BASE_URL = "https://serve.sutro.sh"
JOB_URL_TEMPLATE = "https://app.sutro.sh/jobs/{job_id}"


def _check_backend(backend: str) -> str:
    """``"fleet"`` targets a fleet router, whose wire contract is a single
    server's, so it is the remote transport."""
    if backend not in ("tpu", "remote", "fleet"):
        raise ValueError("backend must be 'tpu', 'remote', or 'fleet'")
    return "remote" if backend == "fleet" else backend


class HTTPError(OSError):
    """A non-2xx answer, raised by ``Response.raise_for_status``; the
    response is ``.response``."""

    def __init__(self, msg: str, response: "Response"):
        super().__init__(msg)
        self.response = response


class Response:
    """The remote backend's answer to one request: the status and the
    body, read whole or (``stream=True``) line by line off the open
    connection."""

    def __init__(self, url: str, status_code: int, raw: Any, stream: bool):
        self.url = url
        self.status_code = int(status_code)
        self.headers = raw.headers
        self._raw = raw
        self._content: Optional[bytes] = None
        if not stream:
            self._read_all()

    def _read_all(self) -> bytes:
        if self._content is None:
            try:
                self._content = self._raw.read()
            finally:
                self._raw.close()
        return self._content

    @property
    def content(self) -> bytes:
        return self._read_all()

    @property
    def text(self) -> str:
        return self.content.decode("utf-8", "replace")

    def json(self) -> Any:
        return json.loads(self.content)

    def iter_lines(self):
        """The body's lines, without their line ends, as they arrive."""
        if self._content is not None:
            yield from self._content.splitlines()
            return
        try:
            for line in self._raw:
                yield line.rstrip(b"\r\n")
        finally:
            self._raw.close()

    def close(self) -> None:
        self._raw.close()

    def raise_for_status(self) -> None:
        if self.status_code >= 400:
            try:
                detail = self.text[:500]
            except OSError:
                detail = ""
            raise HTTPError(
                f"{self.status_code} error for {self.url}: {detail}", self
            )


def _multipart(fields: Dict[str, str], files: Dict[str, Any]) -> tuple:
    """A ``multipart/form-data`` body: (bytes, content type). ``files``
    maps a field to an open binary file."""
    boundary = uuid.uuid4().hex
    out = []
    for name, value in fields.items():
        out.append(
            f'--{boundary}\r\nContent-Disposition: form-data; name="{name}"'
            f"\r\n\r\n{value}\r\n".encode()
        )
    for name, f in files.items():
        fname = os.path.basename(getattr(f, "name", name))
        out.append(
            f'--{boundary}\r\nContent-Disposition: form-data; name="{name}"; '
            f'filename="{fname}"\r\nContent-Type: application/octet-stream'
            "\r\n\r\n".encode() + f.read() + b"\r\n"
        )
    out.append(f"--{boundary}--\r\n".encode())
    return b"".join(out), f"multipart/form-data; boundary={boundary}"


class Sutro(EmbeddingTemplates, ClassificationTemplates, EvalTemplates):
    """Batch LLM inference client over the in-process CUDA engine, or
    over HTTP to a server (``backend="remote"``)."""

    def __init__(
        self,
        api_key: Optional[str] = None,
        base_url: str = DEFAULT_BASE_URL,
        serving_base_url: str = DEFAULT_SERVING_BASE_URL,
        backend: str = "tpu",
        engine_config: Optional[Dict[str, Any]] = None,
    ):
        self.api_key = api_key or check_for_api_key()
        self.base_url = base_url
        self.serving_base_url = serving_base_url
        self.backend = _check_backend(backend)
        self._engine_config = engine_config or {}
        self._engine = None
        check_version()

    # ------------------------------------------------------------------
    # configuration mutators
    # ------------------------------------------------------------------

    def set_api_key(self, api_key: str) -> None:
        self.api_key = api_key

    def set_base_url(self, base_url: str) -> None:
        self.base_url = base_url

    def set_serving_base_url(self, serving_base_url: str) -> None:
        self.serving_base_url = serving_base_url

    def set_backend(self, backend: str) -> None:
        self.backend = _check_backend(backend)

    # ------------------------------------------------------------------
    # transports
    # ------------------------------------------------------------------

    @property
    def engine(self):
        """The process's ``LocalEngine`` (``engine.api.get_engine``),
        built on first use from ``load_engine_config`` and this
        client's ``engine_config``; an engine built before (e.g.
        ``get_engine(ecfg, device="cpu")``) is the one used."""
        if self._engine is None:
            from .engine.api import get_engine
            from .engine.config import load_engine_config

            self._engine = get_engine(
                load_engine_config(**self._engine_config)
            )
        return self._engine

    def do_request(
        self,
        method: str,
        endpoint: str,
        base_url: Optional[str] = None,
        **kwargs: Any,
    ) -> Response:
        """Authenticated HTTP dispatch for the remote backend, over
        ``urllib``. Takes ``json=``, ``data=`` (form fields, or raw
        bytes), ``files=`` (multipart), ``headers=``, ``stream=`` and
        ``timeout=``. Retries HTTP 524 with exponential backoff, at most
        5 tries, and connection failures on idempotent reads (GET/HEAD)
        with a bounded backoff, so a server restart under a polling
        client resumes instead of raising. Other verbs never replay: a
        connection error on a submit is raised, not retried into a
        duplicate job."""
        url = f"{(base_url or self.base_url).rstrip('/')}/{endpoint.lstrip('/')}"
        headers = dict(kwargs.pop("headers", None) or {})
        if self.api_key:
            headers.setdefault("Authorization", f"Key {self.api_key}")
        stream = bool(kwargs.pop("stream", False))
        timeout = kwargs.pop("timeout", None)
        doc, files, data = (kwargs.pop(k, None) for k in ("json", "files", "data"))
        if kwargs:
            raise TypeError(f"do_request: unsupported arguments {sorted(kwargs)}")
        body: Optional[bytes] = None
        if doc is not None:
            body = json.dumps(doc).encode()
            headers["Content-Type"] = "application/json"
        elif files:
            body, headers["Content-Type"] = _multipart(data or {}, files)
        elif data is not None:
            body = bytes(data)
        method = method.upper()
        idempotent = method in ("GET", "HEAD")
        for attempt in range(5):
            req = urllib.request.Request(url, data=body, headers=headers, method=method)
            try:
                raw = urllib.request.urlopen(req, timeout=timeout)
                resp = Response(url, raw.status, raw, stream)
            except urllib.error.HTTPError as e:
                resp = Response(url, e.code, e, stream)
            except OSError:
                if not idempotent or attempt == 4:
                    raise
                time.sleep(min(0.2 * (2 ** attempt), 2.0))
                continue
            if resp.status_code != 524:
                return resp
            resp.close()
            time.sleep(2 ** attempt)
        return resp

    def _remote_json(self, method: str, endpoint: str, **kw: Any) -> Any:
        resp = self.do_request(method, endpoint, **kw)
        resp.raise_for_status()
        return resp.json()

    # ------------------------------------------------------------------
    # core submit path
    # ------------------------------------------------------------------

    def _run_one_batch_inference(
        self,
        data: Any,
        model: str,
        column: Optional[Union[str, List[Any]]],
        output_column: str,
        job_priority: int,
        output_schema: Optional[Dict[str, Any]],
        system_prompt: Optional[str],
        name: Optional[str],
        description: Optional[str],
        dry_run: bool,
        stay_attached: bool,
        truncate_rows: bool,
        random_seed_per_input: bool,
        sampling_params: Optional[Dict[str, Any]],
        tenant: Optional[str] = None,
        stages: Optional[List[Dict[str, Any]]] = None,
    ) -> Any:
        if name and len(name) > MAX_NAME_LENGTH:
            raise ValueError(
                f"name must be <= {MAX_NAME_LENGTH} characters"
            )
        if description and len(description) > MAX_DESCRIPTION_LENGTH:
            raise ValueError(
                f"description must be <= {MAX_DESCRIPTION_LENGTH} characters"
            )
        inputs = prepare_input_data(data, column=column)
        payload = {
            "model": model,
            "inputs": inputs,
            "column": column,
            "job_priority": job_priority,
            "output_schema": output_schema,
            "system_prompt": system_prompt,
            "name": name,
            "description": description,
            "dry_run": dry_run,
            "truncate_rows": truncate_rows,
            "random_seed_per_input": random_seed_per_input,
            "sampling_params": sampling_params,
            "tenant": tenant,
        }
        if stages is not None:
            # key only present for stage-graph jobs: a plain submit's
            # wire payload stays byte-identical
            payload["stages"] = stages
        if self.backend == "remote":
            resp = self.do_request("post", "batch-inference", json=payload)
            if resp.status_code == 400:
                # the server's structured INVALID_PRIORITY body maps back
                # to the typed error the local backend raises
                try:
                    err = resp.json().get("error") or {}
                except ValueError:
                    err = {}
                if err.get("code") == "INVALID_PRIORITY":
                    from .engine.jobstore import InvalidPriority

                    hi = (err.get("valid_range") or [0, 0])[1]
                    raise InvalidPriority(err.get("priority"), hi + 1)
                if err.get("code") == "INVALID_GRAPH":
                    # one exception shape for both backends
                    from .engine.stagegraph import InvalidGraph

                    raise InvalidGraph(
                        err.get("reason") or "invalid",
                        err.get("message") or "invalid stage graph",
                    )
            if resp.status_code != 429:
                resp.raise_for_status()
            # a 429 (the control plane refused the submit) carries the
            # FAILED job's id, as the local backend returns it
            job_id = resp.json()["results"]
        else:
            job_id = self.engine.submit_batch_inference(payload)

        if dry_run:
            with Spinner("Estimating cost...") as sp:
                ok = self.await_job_completion(
                    job_id, obtain_results=False, timeout=600
                )
                if ok is None:
                    sp.fail()
                    return None
            est = self._get_job_cost_estimate(job_id)
            print(
                to_colored_text(
                    f"Estimated cost for this job: ${est:.4f}"
                    if est is not None
                    else "No cost estimate available", "callout",
                )
            )
            return est

        status = self.get_job_status(job_id)
        if status == JobStatus.FAILED.value:
            reason = self._get_failure_reason(job_id)
            print(to_colored_text(f"✗ Job failed: {reason}", "fail"))
            return None

        link = make_clickable_link(JOB_URL_TEMPLATE.format(job_id=job_id))
        if not stay_attached:
            print(to_colored_text(f"Job created: {job_id}", "success"))
            print(to_colored_text(f"View progress at: {link}"))
            return job_id

        started = self._await_job_start(job_id)
        if not started:
            reason = self._get_failure_reason(job_id)
            print(to_colored_text(f"✗ Job did not start: {reason}", "fail"))
            return None
        self._stream_progress_to_tqdm(job_id)

        status = self.get_job_status(job_id)
        if status != JobStatus.SUCCEEDED.value:
            reason = self._get_failure_reason(job_id)
            print(to_colored_text(f"✗ Job {status}: {reason}", "fail"))
            return None

        results_df = self.get_job_results(
            job_id, output_column=output_column
        )
        if results_df is not None and len(results_df):
            preview = results_df.head(5)
            print(to_colored_text("Results preview:", "success"))
            print(preview)
        return job_id

    def _stream_progress_to_tqdm(self, job_id: str) -> None:
        """Consume progress updates into a styled bar."""
        rec = self._fetch_job(job_id)
        total = rec.get("num_rows", 0) or 0
        pbar = fancy_tqdm(total=total, desc="Rows", color="blue")
        token_state: Dict[str, Any] = {}
        stage_state: Dict[str, Any] = {}

        def postfix() -> None:
            parts = []
            tps = token_state.get("total_tokens_processed_per_second")
            if tps is not None:
                parts.append(f"{tps:,.0f} tok/s")
            if stage_state:
                # per-stage rollup (stage-graph jobs): gen 12/50 ...
                parts.append(
                    " ".join(
                        f"{n} {s.get('rows_done', 0)}/"
                        f"{s.get('rows_total', 0)}"
                        for n, s in stage_state.items()
                    )
                )
            if parts:
                pbar.set_postfix_str(" | ".join(parts))

        try:
            for update in self._iter_progress(job_id):
                if update.get("update_type") == "progress":
                    done = int(update.get("result", 0))
                    pbar.update(done - pbar.n)
                elif update.get("update_type") == "tokens":
                    # partial dicts merge monotonically
                    token_state.update(update.get("result") or {})
                    postfix()
                elif update.get("update_type") == "stages":
                    # conflating per-stage counters (the stage_progress
                    # frame): latest rollup wins; a tolerant parse, so a
                    # newer engine's extra keys never break the bar
                    from .engine.stageframes import parse_stage_progress

                    stage_state.update(parse_stage_progress(update) or {})
                    postfix()
        finally:
            pbar.close()

    def _iter_progress(self, job_id: str):
        if self.backend == "remote":
            yield from self._iter_progress_remote(job_id)
        else:
            yield from self.engine.stream_job_progress(job_id)

    def _iter_progress_remote(self, job_id: str):
        """Remote progress tail with reconnect-by-cursor: a stream that
        closes WITHOUT the terminal ``{"t": "end"}`` record means the
        server died mid-stream — reconnect with ``?cursor=<rows done>``
        so the resumed stream carries on where the last one dropped.
        The progress bar's monotone merge makes any overlap harmless."""
        from http.client import HTTPException

        cursor = 0
        retries = 0
        while True:
            try:
                resp = self.do_request(
                    "get", f"stream-job-progress/{job_id}?cursor={cursor}",
                    stream=True,
                )
                resp.raise_for_status()
                for line in resp.iter_lines():
                    if not line:
                        continue
                    update = json.loads(line)
                    if update.get("t") == "end":
                        return
                    if update.get("update_type") == "progress":
                        try:
                            cursor = max(cursor, int(update.get("result") or 0))
                        except (TypeError, ValueError):
                            pass
                    retries = 0
                    yield update
                # closed with no end record: a server that finished
                # without one, or a death mid-stream — disambiguate below
            except HTTPError:
                raise
            except (OSError, HTTPException):
                pass
            retries += 1
            try:
                status = self.get_job_status(job_id)
            except (OSError, HTTPException, ValueError):
                status = None  # server still restarting
            if status is not None and JobStatus(status).is_terminal():
                return
            if retries > 6:
                raise RuntimeError(
                    f"progress stream for {job_id} lost after "
                    f"{retries} reconnect attempts"
                )
            time.sleep(min(0.2 * (2 ** retries), 2.0))

    # ------------------------------------------------------------------
    # interactive serving API (the serving/ tier's OpenAI surface)
    # ------------------------------------------------------------------

    def chat(
        self,
        messages: Union[str, List[Dict[str, Any]]],
        model: str = "qwen-3-4b",
        *,
        stream: bool = False,
        system_prompt: Optional[str] = None,
        response_format: Optional[Dict[str, Any]] = None,
        max_tokens: Optional[int] = None,
        temperature: Optional[float] = None,
        top_p: Optional[float] = None,
        stop: Optional[Union[str, List[str]]] = None,
        seed: Optional[int] = None,
        session_id: Optional[str] = None,
    ) -> Any:
        """One interactive chat completion against the serving tier.

        ``messages`` is a string (one user turn) or an OpenAI-style
        message list. Non-streaming returns the ``chat.completion``
        response dict; ``stream=True`` returns an iterator of
        ``chat.completion.chunk`` dicts (closing it cancels the request
        and frees its engine slot). ``response_format`` takes the OpenAI
        ``json_object`` / ``json_schema`` shapes and routes through the
        engine's constrained decoding. ``session_id`` makes the
        conversation sticky: the server keeps the token transcript (and
        its KV, tiered device -> host -> disk), so each later call with
        the same id sends only the new user turn.

        Remote backends POST ``/v1/chat/completions`` to ``base_url``;
        the local backend submits straight to the engine's gateway,
        which needs ``engine_config={"interactive_slots": N}``, N > 0."""
        if isinstance(messages, str):
            messages = [{"role": "user", "content": messages}]
        else:
            messages = list(messages)
        if system_prompt:
            messages = [{"role": "system", "content": system_prompt}] + messages
        body: Dict[str, Any] = {
            "model": model,
            "messages": messages,
            "stream": bool(stream),
        }
        if response_format is not None:
            body["response_format"] = response_format
        if max_tokens is not None:
            body["max_tokens"] = int(max_tokens)
        if temperature is not None:
            body["temperature"] = float(temperature)
        if top_p is not None:
            body["top_p"] = float(top_p)
        if stop is not None:
            body["stop"] = stop
        if seed is not None:
            body["seed"] = int(seed)
        if session_id is not None:
            body["session_id"] = str(session_id)

        if self.backend == "remote":
            resp = self.do_request(
                "post", "v1/chat/completions", json=body, stream=stream
            )
            if resp.status_code == 404:
                raise RuntimeError(
                    "the server's interactive tier is disabled — start "
                    "it with EngineConfig.interactive_slots > 0"
                )
            resp.raise_for_status()
            if stream:
                return self._iter_sse(resp)
            return resp.json()

        gw = getattr(self.engine, "gateway", None)
        if gw is None:
            raise RuntimeError(
                "interactive serving is disabled: construct "
                "Sutro(engine_config={'interactive_slots': N}) with N > 0"
            )
        from .serving import openai as oai

        ir = gw.submit(oai.parse_request(body, chat=True))
        if stream:
            return self._iter_local_stream(ir)
        return oai.collect(ir, chat=True)

    def _iter_local_stream(self, ir: Any):
        """Local streaming chat: the gateway's channel, heartbeats
        filtered out. An abandoned iterator cancels the request so the
        scheduler frees its slot."""
        from .serving import openai as oai

        try:
            for obj in oai.iter_stream(ir, chat=True):
                if obj is not None:
                    yield obj
        except GeneratorExit:
            ir.channel.cancel()
            raise

    def _iter_sse(self, resp: Response):
        """Parse an SSE chat stream (``data:`` frames until [DONE])."""
        try:
            for raw in resp.iter_lines():
                line = raw.decode()
                if not line.startswith("data:"):
                    continue  # ": ping" heartbeats, blank separators
                data = line[5:].strip()
                if data == "[DONE]":
                    return
                yield json.loads(data)
        finally:
            resp.close()

    # ------------------------------------------------------------------
    # public inference API
    # ------------------------------------------------------------------

    def infer(
        self,
        data: Any,
        model: ModelOptions = "gpt-oss-20b",
        column: Optional[Union[str, List[Any]]] = None,
        output_column: str = "inference_result",
        job_priority: int = 0,
        output_schema: Any = None,
        system_prompt: Optional[str] = None,
        name: Optional[str] = None,
        description: Optional[str] = None,
        dry_run: bool = False,
        stay_attached: Optional[bool] = None,
        truncate_rows: bool = True,
        random_seed_per_input: bool = False,
        sampling_params: Optional[Dict[str, Any]] = None,
        tenant: Optional[str] = None,
    ) -> Any:
        """Submit a batch-inference job. Returns the job id (or the cost
        estimate for ``dry_run=True``).

        ``output_schema`` is a JSON-schema dict or a pydantic model
        class; ``stay_attached`` defaults to ``job_priority == 0``.
        ``tenant`` attributes the job's rows/tokens to a named tenant;
        unset means tenant ``"default"``."""
        if stay_attached is None:
            stay_attached = job_priority == 0
        schema = normalize_output_schema(output_schema)
        if schema is not None and (sampling_params or {}).get("stop"):
            import warnings

            warnings.warn(
                "sampling_params['stop'] is ignored for output_schema "
                "jobs: stopping mid-JSON would break the schema "
                "guarantee (the schema's own closure ends generation)",
                stacklevel=2,
            )
        return self._run_one_batch_inference(
            data=data,
            model=model,
            column=column,
            output_column=output_column,
            job_priority=job_priority,
            output_schema=schema,
            system_prompt=system_prompt,
            name=name,
            description=description,
            dry_run=dry_run,
            stay_attached=stay_attached,
            truncate_rows=truncate_rows,
            random_seed_per_input=random_seed_per_input,
            sampling_params=sampling_params,
            tenant=tenant,
        )

    def run_graph(
        self,
        data: Any,
        stages: List[Dict[str, Any]],
        model: ModelOptions = "gpt-oss-20b",
        column: Optional[Union[str, List[Any]]] = None,
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
        """Submit a stage-graph job: a small DAG of stages executed
        entirely server-side as ONE job (``engine/stagegraph.py``).

        ``stages`` is a list of stage dicts — ``map`` stages carry
        per-stage ``model`` / ``system_prompt`` / ``prompt_template``
        (must contain ``{input}``) / ``output_schema`` /
        ``sampling_params``; ``filter`` / ``elo`` / ``pair`` stages are
        host-side reduces over their upstream stage. Edges are named in
        ``after``; the single sink stage's rows become the job's
        results. Rows stream between stages inside the engine, the whole
        DAG is priced and quota-checked at submit, and an invalid graph
        raises a structured ``InvalidGraph`` (HTTP 400 ``INVALID_GRAPH``
        for remote backends).

        Example — rank + ELO in one submit::

            so.run_graph(rows, stages=[
                {"name": "rank", "kind": "map",
                 "system_prompt": "You are an expert evaluator...",
                 "output_schema": {...}},
                {"name": "elo", "kind": "elo", "after": ["rank"]},
            ])
        """
        if stay_attached is None:
            stay_attached = job_priority == 0
        norm = []
        for s in stages:
            s = dict(s) if isinstance(s, dict) else s
            if isinstance(s, dict) and s.get("output_schema") is not None:
                s["output_schema"] = normalize_output_schema(
                    s["output_schema"]
                )
            norm.append(s)
        return self._run_one_batch_inference(
            data=data,
            model=model,
            column=column,
            output_column=output_column,
            job_priority=job_priority,
            output_schema=None,
            system_prompt=None,
            name=name,
            description=description,
            dry_run=dry_run,
            stay_attached=stay_attached,
            truncate_rows=truncate_rows,
            random_seed_per_input=False,
            sampling_params=sampling_params,
            tenant=tenant,
            stages=norm,
        )

    def infer_per_model(
        self,
        data: Any,
        models: List[str],
        column: Optional[Union[str, List[Any]]] = None,
        names: Optional[List[str]] = None,
        descriptions: Optional[List[str]] = None,
        **kwargs: Any,
    ) -> List[Any]:
        """Fan-out: same data to N models as N detached jobs
        (names/descriptions must match length)."""
        if names is not None and len(names) != len(models):
            raise ValueError("names must be same length as models")
        if descriptions is not None and len(descriptions) != len(models):
            raise ValueError("descriptions must be same length as models")
        job_ids = []
        for i, model in enumerate(models):
            job_ids.append(
                self.infer(
                    data,
                    model=model,
                    column=column,
                    name=names[i] if names else None,
                    description=descriptions[i] if descriptions else None,
                    stay_attached=False,
                    **kwargs,
                )
            )
        return job_ids

    # ------------------------------------------------------------------
    # Functions
    # ------------------------------------------------------------------

    def run_function(
        self,
        name: str,
        input_data: Any,
        **kwargs: Any,
    ) -> Dict[str, Any]:
        """Single online call. The remote backend POSTs
        ``{serving_base_url}/functions/run``; the local one runs a 1-row
        synchronous job against the model the function name resolves
        to. ``input_data`` is a dict, a string or a pydantic model
        (dumped to a dict)."""
        if hasattr(input_data, "model_dump"):
            input_data = input_data.model_dump()

        def _call() -> Dict[str, Any]:
            if self.backend == "remote":
                return self._remote_json(
                    "post", "functions/run", base_url=self.serving_base_url,
                    json={"name": name, "input_data": input_data},
                )
            text = (
                json.dumps(input_data)
                if isinstance(input_data, dict)
                else str(input_data)
            )
            job_id = self.engine.submit_batch_inference(
                {"model": name, "inputs": [text], "job_priority": 0,
                 "truncate_rows": False}
            )
            self._wait_terminal(job_id, timeout=600)
            res = self.engine.job_results(
                job_id, include_cumulative_logprobs=True
            )
            # the confidence is the geometric-mean token probability of
            # the generation (cumulative logprob over the sampled-token
            # count the engine recorded); ``predictions`` stays empty
            logps = res.get("cumulative_logprobs") or [None]
            gen_tokens = (res.get("gen_tokens") or [0])[0]
            confidence = (
                float(math.exp(logps[0] / max(gen_tokens, 1)))
                if logps[0] is not None
                else None
            )
            return {
                "response": res["outputs"][0],
                "confidence": confidence,
                "predictions": [],
                "run_id": job_id,
            }

        return _traced_run(name, _call, inputs={"input_data": input_data})

    def batch_run_function(
        self,
        name: str,
        data: Any,
        column: Optional[Union[str, List[Any]]] = None,
        job_priority: int = 0,
        stay_attached: Optional[bool] = None,
        **kwargs: Any,
    ) -> Any:
        """Functions over tables: rows become JSON dicts, delegated to
        ``infer(model=name, truncate_rows=False)``. A pandas or polars
        DataFrame is recognised through ``sys.modules``."""
        if stay_attached and tracing_enabled():
            raise ValueError(
                "stay_attached=True is incompatible with LangSmith tracing"
            )
        pd, pl = sys.modules.get("pandas"), sys.modules.get("polars")
        if pd is not None and isinstance(data, pd.DataFrame):
            rows = [
                json.dumps(r._asdict() if hasattr(r, "_asdict") else dict(r))
                for r in data.to_dict(orient="records")
            ]
        elif pl is not None and isinstance(data, pl.DataFrame):
            rows = [json.dumps(d) for d in data.to_dicts()]
        else:
            rows = [
                json.dumps(x) if isinstance(x, dict) else str(x) for x in data
            ]
        job_id = self.infer(
            rows,
            model=name,
            job_priority=job_priority,
            stay_attached=stay_attached,
            truncate_rows=False,
            **kwargs,
        )
        if job_id and tracing_enabled():
            _create_batch_traces(job_id, rows, model=name)
        return job_id

    # ------------------------------------------------------------------
    # job lifecycle
    # ------------------------------------------------------------------

    def _fetch_job(self, job_id: str) -> Dict[str, Any]:
        if self.backend == "remote":
            return self._remote_json("get", f"jobs/{job_id}")["job"]
        return self.engine.get_job(job_id)

    def _get_job_cost_estimate(self, job_id: str) -> Optional[float]:
        return self._fetch_job(job_id).get("cost_estimate")

    def _get_failure_reason(self, job_id: str) -> str:
        reason = self._fetch_job(job_id).get("failure_reason") or {}
        return reason.get("message", "unknown")

    def get_job_status(
        self, job_id: str, with_failure_log: bool = False
    ) -> Any:
        """Job status string; with ``with_failure_log`` a dict
        ``{"status", "failure_log", "has_telemetry_dump"}``."""
        if self.backend == "remote":
            status = self._remote_json("get", f"job-status/{job_id}")["job_status"][job_id]
        else:
            status = self.engine.job_status(job_id)
        if with_failure_log:
            rec = self._fetch_job(job_id)
            return {
                "status": status,
                "failure_log": rec.get("failure_log") or [],
                "has_telemetry_dump": bool(rec.get("has_telemetry_dump")),
            }
        return status

    def get_job_failure_log(self, job_id: str) -> List[Dict[str, Any]]:
        """Structured failure events for a job: per-row retries and
        quarantines, transient-I/O retries, torn-chunk quarantines, and
        terminal failures. Empty for clean jobs."""
        return self._fetch_job(job_id).get("failure_log") or []

    def get_job_telemetry(self, job_id: str) -> Dict[str, Any]:
        """The job's flight-recorder document: span timeline across
        engine stages (tokenize, prefill, decode windows, embed, flush,
        finalize, ...) plus exact per-job counters (rows by outcome,
        tokens in/out). Dumped automatically when a job FAILs; this
        fetches and refreshes it on demand."""
        if self.backend == "remote":
            return self._remote_json("get", f"job-telemetry/{job_id}")["telemetry"]
        return self.engine.job_telemetry(job_id)

    def diagnose_job(self, job_id: str) -> Dict[str, Any]:
        """Bottleneck doctor: per-process stage attribution over the
        job's telemetry document, roofline grades for its device
        windows, and one named bottleneck verdict with evidence
        lines."""
        if self.backend == "remote":
            return self._remote_json("get", f"job-doctor/{job_id}")["doctor"]
        return self.engine.diagnose_job(job_id)

    def get_trace(self, ident: str) -> Dict[str, Any]:
        """Chrome trace-event JSON (Perfetto-loadable) for a forensics
        trace id (``tr-...``), a job id whose trace is still in the
        ring, or a plain job id (whole flight record). Raises
        ``KeyError`` locally and a 404 remotely when unknown."""
        if self.backend == "remote":
            return self._remote_json("get", f"trace/{ident}")
        return self.engine.get_trace(ident)

    def get_job_fleet(self, job_id: str) -> Dict[str, Any]:
        """Elastic dp fleet view for a job: per-rank membership state
        (running, idle, lost, drained, late-joined), row ownership, and
        the round's requeue/steal/duplicate counters. Live while the
        coordinator is serving the round, else the snapshot persisted
        at round end; ``{"elastic": False}`` for jobs that never ran
        one. Both backends (the remote server serves it as
        ``GET /job-fleet/{id}``)."""
        if self.backend == "remote":
            return self._remote_json("get", f"job-fleet/{job_id}")["fleet"]
        return self.engine.job_fleet(job_id)

    def get_monitor(self) -> Dict[str, Any]:
        """The live SLO monitor's consolidated document: windowed rates
        and p50/p99 percentiles, per-tenant attribution, SLO rule
        states, the active/recent alert events, the in-flight doctor
        verdicts for running jobs, the tick history trail, and the
        control plane's ``enforcement`` section when it is on. Both
        backends (the remote server serves it as ``GET /monitor``);
        raises ``KeyError`` locally / 404 remotely when the monitor is
        disabled (``SUTRO_TELEMETRY=0`` or ``SUTRO_MONITOR=0``)."""
        if self.backend == "remote":
            return self._remote_json("get", "monitor")["monitor"]
        return self.engine.monitor_doc()

    def get_metrics_text(self) -> str:
        """Engine metrics registry in Prometheus text exposition
        format (the payload ``GET /metrics`` serves)."""
        if self.backend == "remote":
            resp = self.do_request("get", "metrics")
            resp.raise_for_status()
            return resp.text
        from . import telemetry

        return telemetry.REGISTRY.to_prometheus()

    def list_jobs(self) -> List[Dict[str, Any]]:
        if self.backend == "remote":
            return self._remote_json("get", "list-jobs")["jobs"]
        return self.engine.list_jobs()

    def cancel_job(self, job_id: str) -> Dict[str, Any]:
        if self.backend == "remote":
            # the wire contract's GET for a mutation
            return self._remote_json("get", f"job-cancel/{job_id}")
        return self.engine.cancel_job(job_id)

    def resume_job(self, job_id: str) -> Dict[str, Any]:
        """Re-queue a FAILED/CANCELLED (or orphaned) job; rows already in
        the partial store are not recomputed."""
        if self.backend == "remote":
            return self._remote_json("get", f"job-resume/{job_id}")
        return self.engine.resume_job(job_id)

    def _await_job_start(self, job_id: str, timeout: int = 3600) -> bool:
        """Poll until RUNNING/STARTING (True) or FAILED/CANCELLED (False)."""
        poll = self._poll_s()
        deadline = time.monotonic() + timeout
        with Spinner("Waiting for job to start...") as sp:
            while time.monotonic() < deadline:
                status = self.get_job_status(job_id)
                if status in (
                    JobStatus.RUNNING.value,
                    JobStatus.STARTING.value,
                    JobStatus.SUCCEEDED.value,
                ):
                    sp.ok()
                    return True
                if status in (
                    JobStatus.FAILED.value,
                    JobStatus.CANCELLED.value,
                    JobStatus.CANCELLING.value,
                ):
                    sp.fail()
                    return False
                time.sleep(poll)
                poll = self._poll_next(poll)
        sp.fail()
        return False

    def _poll_s(self) -> float:
        """Initial status-poll interval: fast on both backends (a tiny
        job finishes in well under a second); the remote one backs off
        geometrically to 5 s."""
        return 0.1

    def _poll_next(self, poll: float) -> float:
        if self.backend == "tpu":
            return poll
        return min(5.0, poll * 1.6)

    def _wait_terminal(self, job_id: str, timeout: int) -> str:
        poll = self._poll_s()
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            status = self.get_job_status(job_id)
            if JobStatus(status).is_terminal():
                return status
            time.sleep(poll)
            poll = self._poll_next(poll)
        raise TimeoutError(f"Job {job_id} still running after {timeout}s")

    def await_job_completion(
        self,
        job_id: str,
        timeout: int = 7200,
        obtain_results: bool = True,
        output_column: str = "inference_result",
        unpack_json: bool = True,
        with_original_df: Optional[Any] = None,
    ) -> Any:
        """Block until terminal state; fetch results on success (the
        job id when ``obtain_results=False``)."""
        try:
            status = self._wait_terminal(job_id, timeout)
        except TimeoutError:
            print(to_colored_text("✗ Timed out awaiting job", "fail"))
            return None
        if status != JobStatus.SUCCEEDED.value:
            reason = self._get_failure_reason(job_id)
            print(to_colored_text(f"✗ Job {status}: {reason}", "fail"))
            return None
        if not obtain_results:
            return job_id
        return self.get_job_results(
            job_id,
            output_column=output_column,
            unpack_json=unpack_json,
            with_original_df=with_original_df,
        )

    def attach(self, job_id: str) -> None:
        """Re-attach a progress bar to a job."""
        rec = self._fetch_job(job_id)
        status = rec.get("status")
        if status in (JobStatus.FAILED.value, JobStatus.CANCELLED.value):
            print(to_colored_text(f"Cannot attach: job is {status}", "fail"))
            return
        if status == JobStatus.SUCCEEDED.value:
            print(to_colored_text("Job already succeeded", "success"))
            return
        self._stream_progress_to_tqdm(job_id)

    # ------------------------------------------------------------------
    # results
    # ------------------------------------------------------------------

    def _cache_dir(self) -> Path:
        d = config_dir() / "job-results"
        d.mkdir(parents=True, exist_ok=True)
        return d

    def get_job_results(
        self,
        job_id: str,
        include_inputs: bool = False,
        include_cumulative_logprobs: bool = False,
        output_column: str = "inference_result",
        unpack_json: bool = True,
        with_original_df: Optional[Any] = None,
        disable_cache: bool = False,
    ):
        """The job's results as a pandas DataFrame (an ``outputs``
        column renamed to ``output_column``, plus ``inputs`` /
        ``cumulative_logprobs`` when asked), cached as JSON columns."""
        import pandas as pd

        cache_path = self._cache_dir() / f"{job_id}.json"
        expected_cols = 1 + int(include_inputs) + int(
            include_cumulative_logprobs
        )
        df = None
        if not disable_cache and cache_path.exists():
            cached = pd.DataFrame(json.loads(cache_path.read_text()))
            # cache hit requires matching column count
            if len(cached.columns) == expected_cols:
                df = cached.rename(columns={"outputs": output_column})

        if df is None:
            if self.backend == "remote":
                results = self._remote_json(
                    "post", "job-results",
                    json={
                        "job_id": job_id,
                        "include_inputs": include_inputs,
                        "include_cumulative_logprobs": include_cumulative_logprobs,
                    },
                )["results"]
            else:
                results = self.engine.job_results(
                    job_id,
                    include_inputs=include_inputs,
                    include_cumulative_logprobs=include_cumulative_logprobs,
                )
            cols: Dict[str, Any] = {}
            if include_inputs and "inputs" in results:
                cols["inputs"] = results["inputs"]
            cols["outputs"] = results["outputs"]
            if (
                include_cumulative_logprobs
                and "cumulative_logprobs" in results
            ):
                cols["cumulative_logprobs"] = results["cumulative_logprobs"]
            df = pd.DataFrame(cols)
            if not disable_cache:
                cache_path.parent.mkdir(parents=True, exist_ok=True)
                tmp = cache_path.with_name(cache_path.name + ".tmp")
                tmp.write_text(json.dumps(cols))
                tmp.replace(cache_path)
            df = df.rename(columns={"outputs": output_column})

        # LangSmith batch-trace completion
        if tracing_enabled() and _has_open_batch_traces(job_id):
            rec = self._fetch_job(job_id)
            _complete_batch_traces(
                job_id,
                df[output_column].tolist(),
                rec.get("input_tokens", 0) or 0,
                rec.get("output_tokens", 0) or 0,
            )

        if unpack_json:
            df = self._unpack_json_outputs(df, output_column)

        if with_original_df is not None:
            pl = sys.modules.get("polars")
            if pl is not None and isinstance(with_original_df, pl.DataFrame):
                df = with_original_df.with_columns(
                    **{c: pl.Series(df[c]) for c in df.columns}
                )
            elif isinstance(with_original_df, pd.DataFrame):
                df = pd.concat(
                    [
                        with_original_df.reset_index(drop=True),
                        df.reset_index(drop=True),
                    ],
                    axis=1,
                )
        return df

    @staticmethod
    def _unpack_json_outputs(df, output_column: str):
        """If row 0 JSON-decodes to a dict, unpack top-level fields to
        columns; thinking models' {content, reasoning_content} get content
        additionally unpacked (failures no-op)."""
        try:
            if not len(df):
                return df
            first = df[output_column].iloc[0]
            parsed = json.loads(first) if isinstance(first, str) else None
            if not isinstance(parsed, dict):
                return df
            unpacked = [
                json.loads(x) if isinstance(x, str) else {}
                for x in df[output_column]
            ]
            keys = list(parsed.keys())
            if set(keys) == {"content", "reasoning_content"}:
                # thinking models: unpack content struct, drop it
                content = [u.get("content") for u in unpacked]
                df = df.assign(
                    reasoning_content=[
                        u.get("reasoning_content") for u in unpacked
                    ]
                )
                try:
                    inner = [
                        json.loads(c) if isinstance(c, str) else c
                        for c in content
                    ]
                    if inner and isinstance(inner[0], dict):
                        for k in inner[0]:
                            df[k] = [(d or {}).get(k) for d in inner]
                    else:
                        df["content"] = content
                except Exception:
                    df["content"] = content
                return df
            for k in keys:
                df[k] = [u.get(k) for u in unpacked]
            return df
        except Exception:
            return df

    # ------------------------------------------------------------------
    # datasets
    # ------------------------------------------------------------------

    def create_dataset(self) -> str:
        if self.backend == "remote":
            return self._remote_json("get", "create-dataset")["dataset_id"]
        return self.engine.datasets.create()

    def upload_to_dataset(
        self,
        dataset_id: str,
        file_paths: Union[str, List[str]],
        verbose: bool = True,
    ) -> List[str]:
        if isinstance(file_paths, str):
            file_paths = [file_paths]
        if self.backend == "remote":
            uploaded = []
            for path in file_paths:
                with open(path, "rb") as f:
                    self._remote_json(
                        "post", "upload-to-dataset", files={"file": f},
                        data={"dataset_id": dataset_id},
                    )
                uploaded.append(os.path.basename(path))
            return uploaded
        names = self.engine.datasets.upload(dataset_id, file_paths)
        if verbose:
            print(
                to_colored_text(
                    f"✔ Uploaded {len(names)} file(s) to {dataset_id}",
                    "success",
                )
            )
        return names

    def list_datasets(self) -> List[Dict[str, Any]]:
        if self.backend == "remote":
            return self._remote_json("post", "list-datasets")["datasets"]
        return self.engine.datasets.list_datasets()

    def list_dataset_files(self, dataset_id: str) -> List[str]:
        if self.backend == "remote":
            return self._remote_json(
                "post", "list-dataset-files", json={"dataset_id": dataset_id}
            )["files"]
        return self.engine.datasets.list_files(dataset_id)

    def download_from_dataset(
        self,
        dataset_id: str,
        file_names: Optional[Union[str, List[str]]] = None,
        output_path: Optional[str] = None,
    ) -> List[str]:
        if file_names is None:
            file_names = self.list_dataset_files(dataset_id)
        if isinstance(file_names, str):
            file_names = [file_names]
        out_dir = output_path or "."
        if self.backend != "remote":
            return [
                str(self.engine.datasets.download(dataset_id, fname, out_dir))
                for fname in file_names
            ]
        written = []
        for fname in file_names:
            resp = self.do_request(
                "post", "download-from-dataset",
                json={"dataset_id": dataset_id, "file_name": fname},
            )
            resp.raise_for_status()
            dst = Path(out_dir) / fname
            dst.parent.mkdir(parents=True, exist_ok=True)
            dst.write_bytes(resp.content)
            written.append(str(dst))
        return written

    # ------------------------------------------------------------------
    # auth / quotas / cache
    # ------------------------------------------------------------------

    def try_authentication(
        self, api_key: Optional[str] = None
    ) -> Dict[str, Any]:
        if self.backend == "remote":
            return self._remote_json(
                "get", "try-authentication",
                headers={"Authorization": f"Key {api_key or self.api_key}"},
            )
        return self.engine.try_authentication()

    def get_quotas(self) -> List[Dict[str, int]]:
        if self.backend == "remote":
            return self._remote_json("get", "get-quotas")["quotas"]
        return self.engine.get_quotas()

    def get_fleet(self) -> Optional[Dict[str, Any]]:
        """Fleet router snapshot (fleet/remote backend pointed at a
        fleet router, ``fleet/router.py``): replica membership, breaker
        states, failover counters, and the fleet doctor verdict. None
        when the endpoint doesn't exist (single daemon / local backend)."""
        if self.backend != "remote":
            return None
        resp = self.do_request("get", "fleet")
        if resp.status_code == 404:
            return None
        resp.raise_for_status()
        return resp.json().get("fleet")

    def get_fleet_monitor(self) -> Optional[Dict[str, Any]]:
        """Fleet SLO monitor snapshot from a fleet router: fleet-wide
        windowed stats, rule states, alert events with exemplar trace
        ids, and the fleet doctor verdict. None when the endpoint
        doesn't exist (single daemon / local backend); raises
        ``KeyError`` when the router answers but the monitor is
        disabled. The router's 404 carries its reason under ``detail``
        (the JAX SDK reads only ``error``, so there it returns None)."""
        if self.backend != "remote":
            return None
        resp = self.do_request("get", "fleet-monitor")
        if resp.status_code == 404:
            try:
                doc = resp.json()
                detail = doc.get("detail") or doc.get("error") or ""
            except (ValueError, AttributeError):
                detail = ""
            if "disabled" in str(detail):
                raise KeyError(detail)
            return None
        resp.raise_for_status()
        return resp.json().get("fleet_monitor")

    def get_replay_log(self) -> Optional[List[Dict[str, Any]]]:
        """Replayable records drained from a fleet router's trace ring
        (``fleet/replay.py``'s record format). None when the endpoint
        doesn't exist (single daemon / local backend)."""
        if self.backend != "remote":
            return None
        resp = self.do_request("get", "replay-log")
        if resp.status_code == 404:
            return None
        resp.raise_for_status()
        return resp.json().get("records")

    def clear_job_results_cache(self) -> int:
        """Remove $SUTRO_HOME/job-results; returns the files removed."""
        d = self._cache_dir()
        n = len(list(d.glob("*.json")))
        shutil.rmtree(d, ignore_errors=True)
        return n

    def show_job_results_cache(self) -> List[Dict[str, Any]]:
        d = self._cache_dir()
        return [
            {"file": f.name, "size": human_bytes(f.stat().st_size)}
            for f in sorted(d.glob("*.json"))
        ]
