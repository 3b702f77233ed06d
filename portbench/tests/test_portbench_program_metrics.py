"""The readers of the program's own spans (``portbench/recorder.py`` and
the ``*.program``, ``decode_*`` and ``between_calls_share`` metrics), on
synthetic flight-recorder snapshots: the window's bounds, a ring that
evicted part of the window, telemetry off, the step-weighted means and
two sessions whose window numbers overlap; and, at the
program's tiny sizes on the CPU, a traced run that reads them beside the
harness's own spans."""

import json

import pytest

from portbench import harness
from portbench.tests import tiny
from sutro_tpu_torch import telemetry

EPOCH = 1000.0
T_OPEN, T_CLOSE = 1010.0, 1050.0


class Recorder:
    def __init__(self, spans, dropped=0):
        self.epoch_mono = EPOCH
        self.dropped = dropped
        self._spans = spans

    def snapshot(self, job_id=None):
        return [dict(s) for s in self._spans]


class Traffic:
    def __init__(self, rows):
        self.rows = rows
        self.jobs = [{"k": k, "id": f"job-{k}"} for k in range(3)]

    def rows_in(self, t_open, t_close):
        assert (t_open, t_close) == (T_OPEN, T_CLOSE)
        return self.rows


def span(name, t, dur, job=None, **attrs):
    """A span starting at ``t`` on the harness's clock."""
    return {"name": name, "job_id": job, "t0_s": t - EPOCH, "dur_s": dur,
            "attrs": attrs or None}


def read(metric, spans, dropped=0, rows=10, on=True, monkeypatch=None):
    monkeypatch.setattr(telemetry, "RECORDER", Recorder(spans, dropped))
    monkeypatch.setattr(telemetry, "ENABLED", on)
    run = harness.RunView(t_open=T_OPEN, t_close=T_CLOSE, window_s=T_CLOSE - T_OPEN,
                          traffic=Traffic(rows))
    return harness.Bench(harness.ROOT).reader(metric)(run)


# a pipelined run, each window's device time on its dispatch span:
# window 1's dispatch before the open, its fetch inside; windows 2-4
# inside, window 4's fetch after the close; a synchronous decode call;
# a prefill and an admission
PIPELINED = [
    span("decode_window", 1009.0, 0.05, batch=64, steps=8, avg_ctx=300.0, win=1,
         device_s=1.5, gap_s=0.01),
    span("decode_fetch", 1010.5, 1.0, win=1),
    span("decode_window", 1011.6, 0.04, batch=64, steps=8, avg_ctx=308.0, win=2,
         device_s=1.4, gap_s=0.02),
    span("decode_fetch", 1012.0, 1.2, win=2),
    span("prefill", 1013.3, 0.3, tokens=300, batch=2, device_s=0.29, gap_s=0.03),
    span("admit", 1013.6, 0.01, device_s=0.005, gap_s=0.0),
    span("decode_window", 1013.7, 0.06, batch=32, steps=8, avg_ctx=100.0, win=3,
         device_s=1.2, gap_s=0.04),
    span("decode_fetch", 1014.0, 1.1, win=3),
    span("decode_window", 1020.0, 0.2, batch=16, steps=1, avg_ctx=50.0,
         device_s=0.18, gap_s=0.05),
    span("decode_window", 1049.9, 0.05, batch=64, steps=8, avg_ctx=400.0, win=4,
         device_s=1.6, gap_s=0.06),
    span("decode_fetch", 1050.2, 1.0, win=4),
    span("submit", 1001.0, 0.004, job="job-0"), span("submit", 1030.0, 0.008, job="job-1"),
    span("submit", 1051.0, 0.5, job="job-2"),
    # a job of the same process that the run did not submit
    span("submit", 1000.5, 0.9, job="elsewhere"),
]


def test_the_window_holds_the_calls_that_start_inside_it(monkeypatch):
    # windows 2, 3, 4 and the synchronous call start inside; window 1 does not
    steps = 8 + 8 + 8 + 1
    got = read("decode_dispatch_ms", PIPELINED, monkeypatch=monkeypatch)
    assert got == pytest.approx(1e3 * (0.04 + 0.06 + 0.2 + 0.05) / steps)
    got = read("rows_per_step.program", PIPELINED, monkeypatch=monkeypatch)
    assert got == pytest.approx((64 * 8 + 32 * 8 + 16 * 1 + 64 * 8) / steps)
    # window 4's fetch is after the close; its dispatch is inside
    got = read("decode_device_ms", PIPELINED, monkeypatch=monkeypatch)
    assert got == pytest.approx(1e3 * (1.4 + 1.2 + 0.18 + 1.6) / steps)
    # the gaps of the calls that start inside: window 1's not
    got = read("between_calls_share", PIPELINED, monkeypatch=monkeypatch)
    assert got == pytest.approx(100 * (0.02 + 0.03 + 0.0 + 0.04 + 0.05 + 0.06) / 40.0)
    assert read("prefill_tokens_per_row.program", PIPELINED, rows=4,
                monkeypatch=monkeypatch) == pytest.approx(75.0)
    # every submit of the run up to the close, set-up's included; not
    # another job's
    assert read("submit_ms.program", PIPELINED, monkeypatch=monkeypatch) == \
        pytest.approx(6.0)


def test_bounds_are_inclusive(monkeypatch):
    spans = [span("decode_window", T_OPEN, 0.1, batch=4, steps=2, device_s=0.1),
             span("decode_window", T_CLOSE - 0.3, 0.3, batch=8, steps=2, device_s=0.3),
             span("decode_window", T_CLOSE, 0.0, batch=8, steps=2, device_s=0.0),
             span("decode_window", T_CLOSE + 1e-3, 9.0, batch=1, steps=2, device_s=9.0)]
    assert read("rows_per_step.program", spans, monkeypatch=monkeypatch) == pytest.approx(20 / 3)
    assert read("decode_dispatch_ms", spans, monkeypatch=monkeypatch) == pytest.approx(400 / 6)
    assert read("decode_device_ms", spans, monkeypatch=monkeypatch) == pytest.approx(400 / 6)


def test_a_call_open_at_the_close_is_left_out_of_the_per_step_times(monkeypatch):
    # in a traced run the profiler's stop holds the process at the close:
    # the call in flight then lasts as long as the stop
    spans = PIPELINED + [
        span("decode_window", 1049.95, 37.6, batch=64, steps=8, avg_ctx=408.0, win=5,
             device_s=37.5, gap_s=0.001),
        span("decode_fetch", 1087.6, 0.03, win=5)]
    steps = 8 + 8 + 8 + 1
    assert read("decode_dispatch_ms", spans, monkeypatch=monkeypatch) == \
        pytest.approx(1e3 * (0.04 + 0.06 + 0.2 + 0.05) / steps)
    assert read("decode_device_ms", spans, monkeypatch=monkeypatch) == \
        pytest.approx(1e3 * (1.4 + 1.2 + 0.18 + 1.6) / steps)
    # its rows count, as the harness's rows_per_step counts them
    assert read("rows_per_step.program", spans, monkeypatch=monkeypatch) == \
        pytest.approx((64 * 8 + 32 * 8 + 16 + 64 * 8 + 64 * 8) / (steps + 8))


def test_two_sessions_with_the_same_window_numbers_keep_their_own_times(monkeypatch):
    # two batchers' windows in one run, numbered alike: no reader pairs
    # spans by number, so each window keeps its own device time
    spans = []
    for t, dev in ((1011.0, 0.5), (1020.0, 2.0)):
        for w in (1, 2):
            spans.append(span("decode_window", t + w, 0.05, batch=8, steps=4, win=w,
                              device_s=dev, gap_s=0.01))
            spans.append(span("decode_fetch", t + w + 0.1, 0.4, win=w))
    assert read("decode_device_ms", spans, monkeypatch=monkeypatch) == \
        pytest.approx(1e3 * (2 * 0.5 + 2 * 2.0) / 16)
    assert read("between_calls_share", spans, monkeypatch=monkeypatch) == \
        pytest.approx(100 * 4 * 0.01 / 40.0)


NEW = ("decode_dispatch_ms", "decode_device_ms", "between_calls_share",
       "rows_per_step.program", "prefill_tokens_per_row.program", "submit_ms.program")


@pytest.mark.parametrize("metric", NEW)
def test_an_evicted_window_reads_none(metric, monkeypatch):
    # the ring dropped spans and its oldest starts after the open
    late = [s for s in PIPELINED if EPOCH + s["t0_s"] > T_OPEN]
    assert read(metric, late, dropped=3, monkeypatch=monkeypatch) is None
    # dropped spans, but the oldest kept starts before the open: the
    # window is whole (the submits' whole run is not)
    whole = read(metric, PIPELINED, dropped=3, monkeypatch=monkeypatch)
    assert (whole is None) == (metric == "submit_ms.program")


@pytest.mark.parametrize("metric", NEW)
def test_telemetry_off_or_no_figure_reads_none(metric, monkeypatch):
    assert read(metric, PIPELINED, on=False, monkeypatch=monkeypatch) is None
    bare = [dict(s, attrs=None) for s in PIPELINED if s["name"] not in ("submit", "prefill")]
    assert read(metric, bare, monkeypatch=monkeypatch) is None
    assert read(metric, [], monkeypatch=monkeypatch) is None


def test_a_parent_without_device_events_reads_its_host_figures(monkeypatch):
    # the program before its CUDA events: dispatch and fetch both were
    # decode_window spans with the window's shape, no device_s or gap_s
    old = [span("decode_window", 1011.0 + i, 0.05 if i % 2 == 0 else 1.0,
                batch=64, steps=8, avg_ctx=300.0) for i in range(6)]
    assert read("rows_per_step.program", old, monkeypatch=monkeypatch) == 64.0
    assert read("decode_device_ms", old, monkeypatch=monkeypatch) is None
    assert read("between_calls_share", old, monkeypatch=monkeypatch) is None
    assert read("submit_ms.program", old, monkeypatch=monkeypatch) is None


def test_a_prefill_span_without_tokens_reads_none(monkeypatch):
    spans = [span("prefill", 1020.0, 0.1, tokens=10), span("prefill", 1021.0, 0.1)]
    assert read("prefill_tokens_per_row.program", spans, monkeypatch=monkeypatch) is None


def test_a_traced_cpu_run_reads_them_beside_the_harness(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("SUTRO_MONITOR", "0")
    root = tiny.make_root(tmp_path)
    doc = json.loads((root / "BENCHMARK.json").read_text())
    have = {m["name"]: m for m in json.loads((harness.ROOT / "BENCHMARK.json").read_text())
            ["per_layer"]}
    for name in NEW + ("prefill_tokens_per_row",):
        doc["per_layer"].append({k: v for k, v in have[name].items() if k != "workloads"})
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    assert harness.run("tiny-dense.mix", 2**31 + 91, 1.5, True, root=root, device="cpu") == 0
    m = tiny.last_json(capsys.readouterr().out)["metrics"]
    # no CUDA events on the CPU: no device figures
    assert "decode_device_ms" not in m and "between_calls_share" not in m
    assert m["decode_dispatch_ms"]["value"] > 0
    assert m["rows_per_step.program"]["value"] == pytest.approx(
        m["rows_per_step"]["value"], rel=5e-3)
    assert m["prefill_tokens_per_row.program"]["value"] == pytest.approx(
        m["prefill_tokens_per_row"]["value"], rel=5e-3)
    assert 0 < m["submit_ms.program"]["value"] <= m["submit_ms"]["value"]
