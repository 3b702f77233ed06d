"""The port's scheduler spans and their device time, on the CPU.

A tiny-dense engine decodes pipelined windows (``decode_multi_step`` 4,
``decode_lookahead`` 2) with a fake event source in the runner's place
(``telemetry/devicetime.py``): an event completes only when the host
next fetches from the card, as on a CUDA stream, and reading an event
before it completed raises. The tests hold that

- a pipelined window records one ``decode_window`` (dispatch) span and
  one ``decode_fetch`` span, with the same ``win``, and only the
  dispatch carries the window's ``batch``/``steps``/``avg_ctx``; window
  numbers are unique across batchers;
- every timed call's ``device_s`` and ``gap_s`` are the fake events'
  times, once per call, on the call's own span (a pipelined window's on
  its dispatch, written at its fetch);
- no pair is read before its end event completed;
- with telemetry off no event is made or recorded;
- the spans lie inside a ``time.perf_counter`` bracket taken around
  them (the recorder's clock is the benchmark's);
- ``LocalEngine.submit_batch_inference`` records a ``submit`` span.
"""

import time

import numpy as np
import pytest
import torch

from sutro_tpu_torch import telemetry
from sutro_tpu_torch.engine import scheduler
from sutro_tpu_torch.engine.config import EngineConfig
from sutro_tpu_torch.engine.runner import ModelRunner
from sutro_tpu_torch.models.configs import MODEL_CONFIGS
from sutro_tpu_torch.telemetry.devicetime import DeviceClock

MCFG = MODEL_CONFIGS["tiny-dense"]
ENGINE = dict(kv_page_size=8, max_pages_per_seq=16, decode_batch_size=4,
              max_model_len=128, param_dtype="float32", decode_multi_step=4,
              decode_lookahead=2, prefill_chunk=16)
DECODE = ("decode_window", "decode_fetch")


class FakeEvent:
    def __init__(self):
        self.t = None
        self.done = False

    def query(self):
        return self.done

    def elapsed_time(self, end):
        if not (self.done and end.done):
            raise AssertionError("an event read before it completed")
        return (end.t - self.t) * 1e3


class FakeEvents:
    """A card's timing events: an event completes when the host next
    waits on the card (:meth:`sync`)."""

    def __init__(self):
        self.made = 0
        self.times = []        # every record's time, in order
        self._live = []

    def new(self):
        self.made += 1
        return FakeEvent()

    def record(self, ev):
        ev.t, ev.done = time.perf_counter(), False
        self.times.append(ev.t)
        self._live.append(ev)

    def sync(self):
        for ev in self._live:
            ev.done = True
        self._live.clear()


@pytest.fixture(scope="module")
def runner():
    torch.manual_seed(0)
    return ModelRunner(MCFG, EngineConfig(**ENGINE), device="cpu")


@pytest.fixture
def events(runner, monkeypatch):
    """The fake source in the runner; every fetch from the card (the
    scheduler's and the runner's) completes what was recorded before."""
    ev = FakeEvents()
    monkeypatch.setattr(runner, "device_events", ev, raising=False)
    real_host, real_runner_host = scheduler._host, runner._host

    def host(x):
        out = real_host(x)
        ev.sync()
        return out

    def runner_host(x):
        out = real_runner_host(x)
        ev.sync()
        return out

    monkeypatch.setattr(scheduler, "_host", host)
    monkeypatch.setattr(runner, "_host", runner_host)
    return ev


def _run(runner, job_id):
    rng = np.random.default_rng(1)
    reqs = [scheduler.GenRequest(row_id=i, prompt_ids=rng.integers(3, 500, n).astype(np.int32),
                                 max_new_tokens=21, temperature=0.0)
            for i, n in enumerate((5, 9, 12, 3))]
    b = scheduler.ContinuousBatcher(runner, stop_ids=[])
    res = {}
    assert b.run(reqs, on_result=lambda r: res.__setitem__(r.row_id, r),
                 job_id=job_id) == "completed"
    assert len(res) == len(reqs)
    return b


def test_a_pipelined_window_gives_one_dispatch_and_one_fetch_span(runner, events):
    _run(runner, "trace-pipe")
    spans = telemetry.RECORDER.snapshot("trace-pipe")
    wins = {}
    for s in spans:
        if s["name"] in DECODE:
            wins.setdefault(s["attrs"]["win"], []).append(s)
    assert len(wins) >= 5
    for win, pair in wins.items():
        assert [s["name"] for s in pair] == ["decode_window", "decode_fetch"], win
        dispatch, fetch = pair
        assert dispatch["t0_s"] + dispatch["dur_s"] <= fetch["t0_s"] + 1e-6
        assert {"batch", "steps", "avg_ctx"} <= set(dispatch["attrs"])
        assert not {"batch", "steps", "avg_ctx"} & set(fetch["attrs"])
        assert dispatch["attrs"]["steps"] == ENGINE["decode_multi_step"]
    # the window numbers follow the session's dispatch order
    order = [s["attrs"]["win"] for s in spans if s["name"] == "decode_window"
             and "win" in s["attrs"]]
    assert order == sorted(wins)


def test_window_numbers_are_unique_across_batchers(runner, events):
    _run(runner, "trace-win-a")
    _run(runner, "trace-win-b")
    a, b = ({s["attrs"]["win"] for s in telemetry.RECORDER.snapshot(j)
             if s["name"] == "decode_window" and "win" in (s["attrs"] or {})}
            for j in ("trace-win-a", "trace-win-b"))
    assert a and b and not a & b


def test_device_time_comes_from_the_events_once_per_call(runner, events):
    _run(runner, "trace-events")
    spans = telemetry.RECORDER.snapshot("trace-events")
    timed = [s for s in spans if "device_s" in (s.get("attrs") or {})]
    # every call that enqueued work has a pair: the records alternate
    # start, end, and every pair resolved by the session's last fetch
    t = events.times
    assert len(t) % 2 == 0 and len(timed) == len(t) // 2
    want_dev = sorted((t[i + 1] - t[i]) for i in range(0, len(t), 2))
    got_dev = sorted(s["attrs"]["device_s"] for s in timed)
    assert got_dev == pytest.approx(want_dev, rel=1e-9, abs=1e-12)
    want_gap = sorted((t[i] - t[i - 1]) for i in range(2, len(t), 2))
    got_gap = sorted(s["attrs"]["gap_s"] for s in timed if "gap_s" in s["attrs"])
    assert got_gap == pytest.approx(want_gap, rel=1e-9, abs=1e-12)
    by_name = {}
    for s in timed:
        by_name[s["name"]] = by_name.get(s["name"], 0) + 1
    # a pipelined window's device time lands on its dispatch, never on
    # its fetch (which enqueues nothing); prefill and admission calls
    # carry their own
    assert by_name.get("decode_window", 0) >= 5 and "decode_fetch" not in by_name
    assert by_name.get("prefill", 0) >= 1 and by_name.get("admit", 0) >= 1
    dispatches = [s for s in spans if s["name"] == "decode_window"]
    assert all("device_s" in s["attrs"] for s in dispatches)


def test_no_pair_is_read_before_its_end_event_completes():
    ev = FakeEvents()
    clock = DeviceClock(ev)
    a = clock.open()
    clock.close(a)
    b = clock.open()
    clock.close(b)
    span_a, span_b = {}, {}
    clock.settle(b, span_b)
    clock.poll()                     # nothing completed: nothing read
    assert span_b == {} and b.device_s is None
    ev.sync()
    clock.poll()                     # both complete; a resolves first
    assert "device_s" in span_b and "gap_s" in span_b
    clock.settle(a, span_a)          # resolved before it was settled
    assert set(span_a) == {"device_s"}
    c = clock.open()
    clock.close(c)
    assert ev.made == 4              # the pool's events served the last call


def test_telemetry_off_makes_no_event(runner, events):
    was = telemetry.enabled()
    telemetry.set_enabled(False)
    try:
        b = _run(runner, "trace-off")
    finally:
        telemetry.set_enabled(was)
    assert b.timer.clock is None
    assert events.made == 0 and events.times == []


def test_spans_lie_inside_a_perf_counter_bracket(runner, events):
    t_a = time.perf_counter()
    _run(runner, "trace-clock")
    t_b = time.perf_counter()
    spans = telemetry.RECORDER.snapshot("trace-clock")
    assert {"prefill", "decode_window", "decode_fetch"} <= {s["name"] for s in spans}
    epoch = telemetry.RECORDER.epoch_mono
    for s in spans:
        # the snapshot rounds to the microsecond
        assert t_a - 1e-6 <= epoch + s["t0_s"] <= epoch + s["t0_s"] + s["dur_s"] <= t_b + 2e-6


def test_submit_records_a_span(tmp_path, monkeypatch):
    from sutro_tpu_torch.engine import api

    monkeypatch.setenv("SUTRO_HOME", str(tmp_path))
    monkeypatch.setenv("SUTRO_MONITOR", "0")
    eng = api.LocalEngine(EngineConfig(**ENGINE), device="cpu")
    try:
        t_a = time.perf_counter()
        jid = eng.submit_batch_inference({"model": "tiny-dense", "inputs": ["a", "b"],
                                          "dry_run": True})
        t_b = time.perf_counter()
    finally:
        assert eng.close(timeout=30)
    spans = [s for s in telemetry.RECORDER.snapshot(jid) if s["name"] == "submit"]
    assert len(spans) == 1 and spans[0]["job_id"] == jid
    t0 = telemetry.RECORDER.epoch_mono + spans[0]["t0_s"]
    assert t_a - 1e-6 <= t0 and t0 + spans[0]["dur_s"] <= t_b + 2e-6
