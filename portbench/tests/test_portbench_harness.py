"""The harness: it finds configurations, mixes, generators and metrics by
name alone (a new one needs no edit to a file that exists), drives a whole
run at the program's tiny sizes on the CPU, and comes out not correct when
the timed path is broken underneath."""

import json

import pytest

from portbench import harness
from portbench.tests import tiny

SEED = 2**31 + 77


@pytest.fixture
def root(tmp_path, monkeypatch):
    monkeypatch.setenv("SUTRO_MONITOR", "0")
    return tiny.make_root(tmp_path)


def run(root, capsys, cell="tiny-moe.mix", trace=False, seed=SEED):
    assert harness.run(cell, seed, 1.5, trace, root=root, device="cpu") == 0
    out = capsys.readouterr()
    return tiny.last_json(out.out), out.err


def test_a_new_config_mix_and_metric_need_no_edit(root):
    # add files and entries only: a mix, a configuration, a metric, a cell
    (root / "portbench" / "traffic" / "other.json").write_text(json.dumps(dict(tiny.MIX, rows_per_job=3)))
    (root / "portbench" / "configs" / "other.json").write_text(json.dumps(tiny.config("tiny-dense")))
    (root / "portbench" / "metrics" / "answer.now.py").write_text("def read(run):\n    return 42.0\n")
    (root / "portbench" / "limits" / "other.other.json").write_text('{"logit_gap": 1}')
    doc = json.loads((root / "BENCHMARK.json").read_text())
    doc["configs"].append({"name": "other", "source": "x", "file": "portbench/configs/other.json",
                           "reduced": [], "why": "x"})
    doc["workloads"].append({"name": "other.other", "config": "other", "traffic": "other",
                             "chips": 1, "why": "x"})
    doc["per_layer"].append({"name": "answer.now", "unit": "n", "better": "higher",
                             "source": "program_counter", "layer": "x", "moves": "tok_s",
                             "workloads": ["other.other"]})
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    b = harness.Bench(root)
    cell = b.cell("other.other")
    assert b.config(cell["config"])["engine_key"] == "tiny-dense"
    assert b.mix(cell["traffic"])["rows_per_job"] == 3
    assert b.generator(b.mix("other"), 1, "tiny-dense").job(0)["inputs"].__len__() == 3
    names = [m["name"] for m in b.metrics(cell, trace=True)]
    assert "answer.now" in names and "rows_per_step" in names
    assert "answer.now" not in [m["name"] for m in b.metrics(b.cell("tiny-moe.mix"), True)]
    assert b.reader("answer.now")(None) == 42.0
    assert b.limits("other.other") == {"logit_gap": 1}


def test_unknown_cell_is_refused(root):
    with pytest.raises(SystemExit):
        harness.Bench(root).cell("nope")


@pytest.mark.parametrize("cell", ["tiny-dense.mix", "tiny-moe.mix"])
def test_a_whole_run_on_the_cpu(root, capsys, cell):
    res, err = run(root, capsys, cell)
    assert res["correct"] is True
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {"tok_s", "setup_s"}
    assert res["metrics"]["tok_s"]["value"] > 0
    assert res["checks"]["billed_mismatch"]["value"] == 0
    assert res["checks"]["rows_checked"]["value"] >= 1
    # the compared numbers are the last lines of standard error
    assert err.strip().splitlines()[-1].startswith("check ")


def test_decode_busy_leaves_out_what_ran_inside_prefill_calls():
    # device work 0-4 s and 5-9 s; a prefill call from 2 to 6 s: 3 s of it
    # ran inside the call, 5 s outside
    class Spans:
        prefill = [(2.0, 6.0, [(10, 0)], False), (20.0, 21.0, [(10, 0)], False)]
    view = harness.RunView(spans=Spans, t_open=0.0, t_close=10.0, busy_s=8.0,
                           ops=[("a", 0.0, 4.0), ("b", 5.0, 9.0)])
    assert view.decode_busy_s() == pytest.approx(5.0)
    assert harness.RunView(spans=Spans, t_open=0.0, t_close=10.0, busy_s=0.0,
                           ops=[]).decode_busy_s() is None


def test_a_traced_run_reads_the_per_layer_metrics(root, capsys):
    res, _ = run(root, capsys, trace=True)
    assert res["correct"] is True
    assert {"rows_per_step", "submit_ms"} <= set(res["metrics"])
    assert 0 < res["metrics"]["rows_per_step"]["value"] <= tiny.ENGINE["decode_batch_size"]
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert "idle_gaps" in res["breakdown"]


def _alter_tokens(monkeypatch):
    import sutro_tpu_torch.engine.runner as runner

    real = runner.sample

    def altered(logits, *a, **kw):
        return (real(logits, *a, **kw) + 1) % logits.shape[-1]

    monkeypatch.setattr(runner, "sample", altered)


def _state_unchanged(monkeypatch):
    import sutro_tpu_torch.engine.runner as runner

    monkeypatch.setattr(runner, "write_kv", lambda *a, **kw: None)


def _bill_off(monkeypatch):
    import sutro_tpu_torch.engine.api as api

    real = api._GenSession.on_progress

    def padded(self, p):
        real(self, dict(p, input_tokens=p["input_tokens"] + 1))

    monkeypatch.setattr(api._GenSession, "on_progress", padded)


@pytest.mark.parametrize("fault", [_alter_tokens, _state_unchanged, _bill_off],
                         ids=["token_altered", "kv_write_left_out", "bill_off_by_one"])
def test_a_broken_path_is_not_correct(root, capsys, monkeypatch, fault):
    fault(monkeypatch)
    res, _ = run(root, capsys)
    assert res["correct"] is False


def _traffic(records):
    t = harness.Traffic.__new__(harness.Traffic)
    t.records, t._lock = records, __import__("threading").Lock()
    return t


@pytest.mark.parametrize("queued_first", [True, False])
def test_the_rate_counts_the_whole_window_in_any_record_order(queued_first):
    # job 0 decodes 512 tokens a call, a call every 1.5 s, ending at 0, 1.5,
    # ..., 6.0; job 1 waits, and its follower records 0 at each call's end,
    # a microsecond before or after job 0's
    recs = []
    for i in range(5):
        t = 1.5 * i
        own, other = (t + 1e-6, t) if queued_first else (t, t + 1e-6)
        recs += [(own, 0, "tokens", 1000 + 512 * i), (other, 1, "tokens", 0)]
    traffic = _traffic(recs)
    # a window from 0.5 to 5.0 s: two thirds of the first call's bill in
    # it, the second and third calls whole, a third of the fourth
    assert traffic.rate(0.5, 5.0) == pytest.approx(512 * 3 / 4.5)
    assert traffic.billed_at(-1.0) == 0.0


def test_the_rate_bills_a_jobs_prompts_at_its_first_record():
    recs = [(0.0, 0, "tokens", 100), (2.0, 0, "tokens", 300), (1.0, 1, "tokens", 5000)]
    traffic = _traffic(recs)
    assert traffic.billed_at(0.99) == pytest.approx(100 + 99)
    assert traffic.billed_at(1.0) == pytest.approx(200 + 5000)
    assert traffic.rate(0.5, 1.5) == pytest.approx(5100.0)
