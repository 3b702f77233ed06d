"""The elastic dp rounds of the port's ``engine/dphost.py`` against the
JAX package's: each scenario of ``tests/test_elastic.py`` run through
both packages' dphost (``tests.test_torch_dphost.both``), with the
same outcome, the same merged rows (each exactly once, bit-identical to
a fault-free run) and the same membership events and counters where
the scenario fixes them.

Worker crash, hang, mid-frame drop, preemption drain (the fault site
and SIGTERM), late join, work stealing, every worker dying, a rank that
never connects, old peers on either side, a coordinator crash with its
resume, the ``EngineConfig`` channel knobs, seeded reconnect backoff,
the resume round's bind retry, the requeue limit and the elastic state
unit.
"""

import importlib
import os
import signal
import socket
import threading
import time

import pytest

from tests.test_torch_dphost import PACKAGES, Pkg, _connect, both

N_ROWS = 256


@pytest.fixture(autouse=True)
def _clean_channel_state():
    """Every scenario starts with no fault plan, no sticky drain flag,
    and the EngineConfig channel overrides reset, in both packages."""
    yield
    for root in PACKAGES:
        P = Pkg(root)
        P.faults.clear()
        P.dphost._DRAIN.clear()
        P.dphost._CHANNEL_CFG.update({"stall_timeout": None, "heartbeat": None})


def _reqs(P, n=N_ROWS):
    return P.reqs(n, prompt=(1, 2))


def _res(P, row_id):
    # per-row-distinct content so "bit-identical merge" is a real claim
    return P.res(row_id, token_ids=(row_id % 11, 7))


def _shard_fn(P, ran=None, per_row=None):
    """Deterministic stub shard runner. ``ran`` collects executed row
    ids; ``per_row(row_id)`` runs before each row."""

    def fn(shard, on_result, on_progress, should_cancel):
        for q in shard:
            if should_cancel():
                return "cancelled"
            if per_row is not None:
                per_row(q.row_id)
            if ran is not None:
                ran.append(q.row_id)
            on_result(_res(P, q.row_id))
        return "completed"

    return fn


class _Merge:
    """Coordinator-side merge recorder: counts on_result calls per row
    so a duplicate merge is detected, not absorbed."""

    def __init__(self):
        self.lock = threading.Lock()
        self.counts = {}
        self.results = {}

    def __call__(self, res):
        with self.lock:
            self.counts[res.row_id] = self.counts.get(res.row_id, 0) + 1
            self.results[res.row_id] = list(res.token_ids)

    def assert_complete_no_dups(self, n=N_ROWS):
        assert set(self.results) == set(range(n)), (
            f"lost rows: {sorted(set(range(n)) - set(self.results))[:16]}"
        )
        dups = {r: c for r, c in self.counts.items() if c != 1}
        assert not dups, f"duplicate merges reached on_result: {dups}"
        for rid, toks in self.results.items():
            assert toks == [rid % 11, 7]
        return sorted(self.results)


class _Events:
    def __init__(self):
        self.lock = threading.Lock()
        self.items = []

    def __call__(self, ev):
        with self.lock:
            self.items.append(dict(ev))

    def of(self, kind):
        with self.lock:
            return [e for e in self.items if e.get("event") == kind]


def _spawn_worker(P, world, shard_fn, pool, *, elastic=True, outcomes=None, name=None):
    key = name or f"rank{world.rank}"

    def main():
        try:
            out = P.dphost.run_dp_worker(world, shard_fn, pool, elastic=elastic)
        except Exception as e:  # noqa: BLE001 — injected faults re-raise
            out = f"raised:{type(e).__name__}"
        if outcomes is not None:
            outcomes[key] = out

    t = threading.Thread(target=main, daemon=True, name=f"dpw-{key}")
    t.start()
    return t


def _join_all(threads, timeout=120):
    for t in threads:
        t.join(timeout=timeout)
        assert not t.is_alive()


# ---------------------------------------------------------------------------
# the chaos gate: crash / hang / torn frame / preempt / late join
# ---------------------------------------------------------------------------


def _clean_round(P, port):
    cw, w1, w2, w3 = P.worlds(port, 4)
    reqs = _reqs(P)
    merge, events, outcomes = _Merge(), _Events(), {}
    threads = [_spawn_worker(P, w, _shard_fn(P), reqs, outcomes=outcomes) for w in (w1, w2, w3)]
    outcome = P.dphost.run_dp_coordinator(
        cw, _shard_fn(P), P.dphost.shard_requests(reqs, 0, 4),
        on_result=merge, on_row_event=events, requests=reqs, job_id="job-clean",
    )
    _join_all(threads)
    snap = P.dphost.fleet_view("job-clean")
    return {
        "outcome": outcome, "workers": sorted(outcomes.values()),
        "merged": merge.assert_complete_no_dups(),
        "joined": sorted(e["rank"] for e in events.of("dp_worker_joined")),
        "elastic": snap["elastic"], "rows": snap["rows"],
        "counters": snap["counters"], "states": {r: v["state"] for r, v in snap["ranks"].items()},
    }


def test_elastic_clean_round_three_workers():
    """A 256-row job across a coordinator and 3 elastic workers merges
    every row exactly once, and the fleet view reports the round."""
    got = both(_clean_round)
    assert got["outcome"] == "completed" and got["workers"] == ["completed"] * 3
    assert got["joined"] == [1, 2, 3] and got["elastic"] is True
    assert got["rows"]["done"] == N_ROWS and got["rows"]["pending"] == 0


def _crash_after_join(P, port):
    P.faults.configure("dphost.join:crash:times=1")
    cw, w1, w2 = P.worlds(port, 3)
    reqs = _reqs(P)
    merge, events, outcomes = _Merge(), _Events(), {}
    threads = [_spawn_worker(P, w, _shard_fn(P), reqs, outcomes=outcomes) for w in (w1, w2)]
    outcome = P.dphost.run_dp_coordinator(
        cw, _shard_fn(P), P.dphost.shard_requests(reqs, 0, 3),
        on_result=merge, on_row_event=events, requests=reqs,
    )
    _join_all(threads)
    req_evts = events.of("dp_rows_requeued")
    return {
        "outcome": outcome, "merged": merge.assert_complete_no_dups(),
        "requeued": bool(req_evts) and sum(e["rows"] for e in req_evts) >= 1,
        "completed_workers": sorted(outcomes.values()).count("completed"),
    }


def test_elastic_worker_crash_after_join_requeues_and_completes():
    """A worker dying right after admission loses its assignment; the
    rows requeue onto the surviving rank and the round completes."""
    got = both(_crash_after_join)
    assert got["outcome"] == "completed" and got["requeued"] is True
    assert got["completed_workers"] == 1


def _hang(P, port, monkeypatch):
    monkeypatch.setenv("SUTRO_DP_STALL_TIMEOUT", "1")
    # healthy ranks must beat the 1 s stall bound even while parked idle
    monkeypatch.setenv("SUTRO_DP_HEARTBEAT", "0.2")
    cw, _w1, w2 = P.worlds(port, 3)
    reqs = _reqs(P)
    merge, events, outcomes = _Merge(), _Events(), {}
    hung = threading.Event()

    def hung_rank1():
        sock = _connect(port, timeout=60)
        P.dphost._send(sock, {"t": "hello", "rank": 1, "job": "", "elastic": 1})
        next(P.dphost._recv_lines(sock), None)  # resume reply
        hung.set()
        time.sleep(60)  # wedged: no results, no heartbeat
        sock.close()

    threading.Thread(target=hung_rank1, daemon=True).start()
    t = _spawn_worker(P, w2, _shard_fn(P), reqs, outcomes=outcomes)
    t0 = time.monotonic()
    outcome = P.dphost.run_dp_coordinator(
        cw, _shard_fn(P), P.dphost.shard_requests(reqs, 0, 3),
        on_result=merge, on_row_event=events, requests=reqs,
    )
    fast = time.monotonic() - t0 < 60  # the stall bound, not the accept bound
    _join_all([t])
    return {
        "outcome": outcome, "fast": fast, "merged": merge.assert_complete_no_dups(),
        "hung": hung.is_set(),
        "stall_requeue": any(e.get("reason") == "stall" for e in events.of("dp_rows_requeued")),
        "rank2": outcomes.get("rank2"),
    }


def test_elastic_worker_hang_stalled_rows_requeued(monkeypatch):
    """A worker silent mid-round is declared stalled by the watchdog;
    the elastic round requeues its rows and completes."""
    got = both(_hang, monkeypatch)
    assert got["outcome"] == "completed" and got["fast"] and got["hung"]
    assert got["stall_requeue"] is True and got["rank2"] == "completed"


def _mid_frame_drop(P, port):
    P.faults.configure("dphost.send:drop:nth=5,times=1")
    cw, w1, w2 = P.worlds(port, 3)
    reqs = _reqs(P)
    merge, events, outcomes = _Merge(), _Events(), {}
    threads = [_spawn_worker(P, w, _shard_fn(P), reqs, outcomes=outcomes) for w in (w1, w2)]
    outcome = P.dphost.run_dp_coordinator(
        cw, _shard_fn(P), P.dphost.shard_requests(reqs, 0, 3),
        on_result=merge, on_row_event=events, requests=reqs,
    )
    _join_all(threads)
    return {
        "outcome": outcome, "merged": merge.assert_complete_no_dups(),
        "requeued": bool(events.of("dp_rows_requeued")),
    }


def test_elastic_mid_frame_drop_requeues_torn_row():
    """A connection torn mid-frame loses no row: the dead rank's
    remainder requeues and the merge stays bit-identical."""
    got = both(_mid_frame_drop)
    assert got["outcome"] == "completed" and got["requeued"] is True


def _preempt_drain(P, port, monkeypatch):
    monkeypatch.setenv("SUTRO_DP_REQUEUE_LIMIT", "0")
    P.faults.configure("dphost.preempt:error:nth=10,times=1")
    cw, w1, w2 = P.worlds(port, 3)
    reqs = _reqs(P)
    merge, events, outcomes = _Merge(), _Events(), {}
    threads = [_spawn_worker(P, w, _shard_fn(P), reqs, outcomes=outcomes) for w in (w1, w2)]
    outcome = P.dphost.run_dp_coordinator(
        cw, _shard_fn(P), P.dphost.shard_requests(reqs, 0, 3),
        on_result=merge, on_row_event=events, requests=reqs,
    )
    _join_all(threads)
    return {
        "outcome": outcome, "merged": merge.assert_complete_no_dups(),
        "drains": len(events.of("dp_preempt_drain")),
        "workers": sorted(outcomes.values()),
    }


def test_elastic_preempt_drain_via_fault_site(monkeypatch):
    """The dphost.preempt site: a worker drains mid-shard and the round
    completes without it; with the requeue limit at 0 a drain is not
    counted against the rows."""
    got = both(_preempt_drain, monkeypatch)
    assert got["outcome"] == "completed" and got["drains"] == 1
    assert got["workers"] == ["completed", "drained"]


def _sigterm_drain(P, port):
    cw, w1, w2 = P.worlds(port, 3)
    reqs = _reqs(P)
    merge, events, outcomes, coord_out = _Merge(), _Events(), {}, {}

    def coord_main():
        coord_out["v"] = P.dphost.run_dp_coordinator(
            cw, _shard_fn(P), P.dphost.shard_requests(reqs, 0, 3),
            on_result=merge, on_row_event=events, requests=reqs,
        )

    ct = threading.Thread(target=coord_main, daemon=True)
    ct.start()
    _spawn_worker(P, w2, _shard_fn(P), reqs, outcomes=outcomes)
    fired = threading.Event()

    def preempt(row_id):
        # preempt this rank a few rows in, once rank 2 has joined (the
        # drain flag is process-wide)
        if row_id > 10 and not fired.is_set():
            deadline = time.monotonic() + 20
            while time.monotonic() < deadline:
                with merge.lock:
                    if any(r % 3 == 2 for r in merge.results):
                        break
                time.sleep(0.01)
            fired.set()
            os.kill(os.getpid(), signal.SIGTERM)

    prev_handler = signal.getsignal(signal.SIGTERM)
    out = P.dphost.run_dp_worker(w1, _shard_fn(P, per_row=preempt), reqs, elastic=True)
    restored = signal.getsignal(signal.SIGTERM) == prev_handler
    ct.join(timeout=120)
    assert not ct.is_alive()
    return {
        "worker": out, "restored": restored, "coord": coord_out["v"],
        "merged": merge.assert_complete_no_dups(),
        "drained": bool(events.of("dp_preempt_drain")),
    }


def test_elastic_sigterm_drains_main_thread_worker():
    """SIGTERM on an elastic worker on the main thread drains it, and
    the previous handler is restored."""
    got = both(_sigterm_drain)
    assert got["worker"] == "drained" and got["restored"] is True
    assert got["coord"] == "completed" and got["drained"] is True


def _late_joiner(P, port):
    plan = P.faults.configure("dphost.join:crash:times=1")
    cw, w1 = P.worlds(port, 2)
    late = P.dphost.DPWorld(rank=7, world=2, host="127.0.0.1", port=port)
    reqs = _reqs(P)
    merge, outcomes, events = _Merge(), {}, _Events()
    late_joined = threading.Event()

    def on_evt(ev):
        events(ev)
        if ev.get("event") == "dp_worker_joined" and ev.get("late_join"):
            late_joined.set()

    threads = [_spawn_worker(P, w1, _shard_fn(P), reqs, outcomes=outcomes)]

    def _admit_late():
        # the crash clause must hit w1, and `late` must join before the
        # coordinator runs its own rows
        deadline = time.monotonic() + 60
        while plan.specs[0].fires < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        threads.append(_spawn_worker(P, late, _shard_fn(P), reqs, outcomes=outcomes, name="late"))

    gate = threading.Thread(target=_admit_late, daemon=True)
    gate.start()
    outcome = P.dphost.run_dp_coordinator(
        cw, _shard_fn(P, per_row=lambda _rid: late_joined.wait(timeout=60)),
        P.dphost.shard_requests(reqs, 0, 2),
        on_result=merge, on_row_event=on_evt, requests=reqs, job_id="job-late",
    )
    gate.join(timeout=90)
    _join_all(threads[:1])
    # the JAX coordinator can leave a rank admitted as the round ends
    # parked for good (test_late_admission_at_round_end_is_released)
    threads[1].join(timeout=10)
    if threads[1].is_alive():
        P.dphost.request_drain()
        threads[1].join(timeout=10)
    joins = events.of("dp_worker_joined")
    return {
        "outcome": outcome, "merged": merge.assert_complete_no_dups(),
        "late_join": any(e["late_join"] for e in joins),
        "fresh_rank": any(e["rank"] >= 2 for e in joins),
    }


def test_elastic_late_joiner_absorbs_requeued_rows():
    """A rank joining outside the fixed world gets a fresh rank and
    absorbs a dead worker's requeued rows."""
    got = both(_late_joiner)
    assert got["outcome"] == "completed" and got["late_join"] and got["fresh_rank"]


def _late_admission_at_round_end(P, port, monkeypatch):
    """A late joiner whose handshake is still in the coordinator's
    acceptor when the round ends: its resume reply is held until the
    coordinator has returned. Returns whether the joiner's thread ended
    within 5 s of the release."""
    cw, w1 = P.worlds(port, 2)
    late = P.dphost.DPWorld(rank=7, world=2, host="127.0.0.1", port=port)
    reqs = _reqs(P, 16)
    admitted, release = threading.Event(), threading.Event()
    send = P.dphost._send

    def held_send(sock, msg):
        if msg.get("t") == "resume" and msg.get("rank", 0) >= 2:
            admitted.set()
            release.wait(timeout=60)
        send(sock, msg)

    monkeypatch.setattr(P.dphost, "_send", held_send)
    outcomes = {}
    w1_thread = _spawn_worker(P, w1, _shard_fn(P), reqs, outcomes=outcomes)
    late_thread = None

    w1_joined = threading.Event()

    def on_evt(ev):
        if ev.get("event") == "dp_worker_joined" and ev.get("rank") == 1:
            w1_joined.set()

    def local(shard, on_result, on_progress, should_cancel):
        # rank 1 is admitted first (the acceptor serves one handshake
        # at a time, and the late one is held)
        nonlocal late_thread
        assert w1_joined.wait(timeout=60)
        late_thread = _spawn_worker(P, late, _shard_fn(P), reqs, outcomes=outcomes, name="late")
        assert admitted.wait(timeout=60)
        return _shard_fn(P)(shard, on_result, on_progress, should_cancel)

    merge = _Merge()
    outcome = P.dphost.run_dp_coordinator(
        cw, local, P.dphost.shard_requests(reqs, 0, 2),
        on_result=merge, on_row_event=on_evt, requests=reqs,
    )
    release.set()
    _join_all([w1_thread])
    late_thread.join(timeout=5)
    ended = not late_thread.is_alive()
    if not ended:
        P.dphost.request_drain()  # unpark it: the drain check polls
        late_thread.join(timeout=10)
    return {"outcome": outcome, "merged": merge.assert_complete_no_dups(16), "ended": ended}


def test_late_admission_at_round_end_is_released(monkeypatch):
    """A rank admitted while the round ends is released at once (EOF)
    by the port's coordinator. The JAX package's registers the
    connection after its teardown closed the others, and the rank parks
    idle until its process dies."""
    from tests.conftest import free_low_port

    port = _late_admission_at_round_end(
        Pkg("sutro_tpu_torch"), free_low_port(), monkeypatch
    )
    assert port == {"outcome": "completed", "merged": list(range(16)), "ended": True}
    monkeypatch.undo()
    ref = _late_admission_at_round_end(Pkg("sutro_tpu"), free_low_port(), monkeypatch)
    assert ref["outcome"] == "completed" and ref["ended"] is False


def _steal_race(P, port):
    P.faults.configure("dphost.steal:error:times=1")
    cw, w1, w2 = P.worlds(port, 3)
    reqs = _reqs(P, 36)  # the straggler sleeps a row; keep the tail short
    merge, events, outcomes = _Merge(), _Events(), {}

    def slow(row_id):
        time.sleep(0.08)

    def gate(row_id):
        # rank 2 parks idle only after the straggler has joined
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            with merge.lock:
                if any(r % 3 == 1 for r in merge.results):
                    return
            time.sleep(0.01)

    threads = [
        _spawn_worker(P, w1, _shard_fn(P, per_row=slow), reqs, outcomes=outcomes, name="straggler"),
        _spawn_worker(P, w2, _shard_fn(P, per_row=gate), reqs, outcomes=outcomes),
    ]
    outcome = P.dphost.run_dp_coordinator(
        cw, _shard_fn(P), P.dphost.shard_requests(reqs, 0, 3),
        on_result=merge, on_row_event=events, requests=reqs, job_id="job-steal",
    )
    _join_all(threads)
    steals = events.of("dp_rows_stolen")
    assert len(steals) == 1, events.items
    snap = P.dphost.fleet_view("job-steal")
    return {
        "outcome": outcome, "merged": merge.assert_complete_no_dups(36),
        "victim_thief": (steals[0]["victim"], steals[0]["thief"]),
        "counted": snap["counters"]["stolen_rows"] == steals[0]["rows"],
    }


def test_elastic_steal_race_first_result_wins():
    """Work stealing: the straggler's tail is dual-assigned, both ranks
    may stream the same rows, exactly one copy reaches the merge."""
    got = both(_steal_race)
    assert got["outcome"] == "completed" and got["victim_thief"] == (1, 2)
    assert got["counted"] is True


def _all_workers_die(P, port):
    P.faults.configure("dphost.join:crash:times=2")
    cw, w1, w2 = P.worlds(port, 3)
    reqs = _reqs(P)
    merge, events, outcomes, local_ran = _Merge(), _Events(), {}, []
    threads = [_spawn_worker(P, w, _shard_fn(P), reqs, outcomes=outcomes) for w in (w1, w2)]
    outcome = P.dphost.run_dp_coordinator(
        cw, _shard_fn(P, ran=local_ran), P.dphost.shard_requests(reqs, 0, 3),
        on_result=merge, on_row_event=events, requests=reqs,
    )
    _join_all(threads)
    return {
        "outcome": outcome, "merged": merge.assert_complete_no_dups(),
        # rank 0 ran more than its own stride: it claimed the orphans
        "rank0_claimed": len(local_ran) > len(P.dphost.shard_requests(reqs, 0, 3)),
        "workers_raised": all(v.startswith("raised:") for v in outcomes.values()),
    }


def test_elastic_all_workers_die_rank0_claims_everything():
    """Every worker dies after joining; rank 0 claims and runs the
    orphaned rows itself."""
    got = both(_all_workers_die)
    assert got["outcome"] == "completed" and got["rank0_claimed"] and got["workers_raised"]


def _never_connected(P, port, monkeypatch):
    monkeypatch.setenv("SUTRO_DP_JOIN_GRACE", "1.5")
    cw, w1, _w2 = P.worlds(port, 3)  # rank 2 never shows up
    reqs = _reqs(P, 64)
    merge, events, outcomes = _Merge(), _Events(), {}
    t = _spawn_worker(P, w1, _shard_fn(P), reqs, outcomes=outcomes)
    outcome = P.dphost.run_dp_coordinator(
        cw, _shard_fn(P), P.dphost.shard_requests(reqs, 0, 3),
        on_result=merge, on_row_event=events, requests=reqs,
    )
    _join_all([t])
    return {
        "outcome": outcome, "merged": merge.assert_complete_no_dups(64),
        "released": any(
            e.get("reason") == "never_connected_within_join_grace"
            for e in events.of("dp_rows_requeued")
        ),
    }


def test_elastic_never_connected_rank_released_after_join_grace(monkeypatch):
    """A reserved rank that never connects stops blocking the round
    after SUTRO_DP_JOIN_GRACE."""
    got = both(_never_connected, monkeypatch)
    assert got["outcome"] == "completed" and got["released"] is True


# ---------------------------------------------------------------------------
# protocol degradation: old peers on either side
# ---------------------------------------------------------------------------


def _old_worker(P, port):
    cw, w1 = P.worlds(port, 2)
    reqs = _reqs(P, 64)
    merge, events, ran = _Merge(), _Events(), []
    t = _spawn_worker(
        P, w1, _shard_fn(P, ran=ran), P.dphost.shard_requests(reqs, 1, 2),
        elastic=False, name="v1",
    )
    outcome = P.dphost.run_dp_coordinator(
        cw, _shard_fn(P), P.dphost.shard_requests(reqs, 0, 2),
        on_result=merge, on_row_event=events, requests=reqs,
    )
    _join_all([t])
    joins = events.of("dp_worker_joined")
    return {
        "outcome": outcome, "merged": merge.assert_complete_no_dups(64),
        "ran": sorted(ran), "joined_elastic": [e["elastic"] for e in joins],
    }


def test_old_worker_with_elastic_coordinator_runs_fixed_stride():
    """A worker without the elastic hello runs exactly its stride."""
    got = both(_old_worker)
    assert got["outcome"] == "completed" and got["joined_elastic"] == [False]
    assert got["ran"] == [i for i in range(64) if i % 2 == 1]


def _old_coordinator(P, port):
    cw, w1 = P.worlds(port, 2)
    reqs = _reqs(P, 64)
    merge, ran, outcomes = _Merge(), [], {}
    t = _spawn_worker(P, w1, _shard_fn(P, ran=ran), reqs, elastic=True, outcomes=outcomes)
    # requests=None -> the coordinator runs the fixed-world round
    outcome = P.dphost.run_dp_coordinator(
        cw, _shard_fn(P), P.dphost.shard_requests(reqs, 0, 2), on_result=merge,
    )
    _join_all([t])
    return {
        "outcome": outcome, "worker": outcomes["rank1"],
        "merged": merge.assert_complete_no_dups(64), "ran": sorted(ran),
    }


def test_elastic_worker_with_old_coordinator_degrades_to_stride():
    """An elastic worker given no assignment falls back to its stride."""
    got = both(_old_coordinator)
    assert got["outcome"] == "completed" and got["worker"] == "completed"
    assert got["ran"] == [i for i in range(64) if i % 2 == 1]


# ---------------------------------------------------------------------------
# coordinator crash mid-round: restart + resume replays only missing rows
# ---------------------------------------------------------------------------


def _coordinator_crash(P, port):
    from tests.conftest import free_low_port

    reqs = _reqs(P, 96)
    merge = _Merge()
    cw, w1, w2 = P.worlds(port, 3)
    outcomes = {}

    def dawdle(row_id):
        time.sleep(0.02)

    def crashing_local(shard, on_result, on_progress, should_cancel):
        for q in shard[:10]:
            on_result(_res(P, q.row_id))
        # die once both workers have merged rows
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            with merge.lock:
                if {r % 3 for r in merge.results} >= {1, 2}:
                    break
            time.sleep(0.01)
        raise RuntimeError("rank0 host died")

    threads = [
        _spawn_worker(P, w, _shard_fn(P, per_row=dawdle), reqs, outcomes=outcomes)
        for w in (w1, w2)
    ]
    with pytest.raises(RuntimeError, match="rank0 host died"):
        P.dphost.run_dp_coordinator(
            cw, crashing_local, P.dphost.shard_requests(reqs, 0, 3),
            on_result=merge, requests=reqs,
        )
    _join_all(threads, timeout=60)
    survived = set(merge.results)
    assert survived and survived != set(range(96))
    assert {r % 3 for r in set(range(96)) - survived} == {0, 1, 2}

    # restart: the same pool, the done set what merged before the crash
    cw2, w1b, w2b = P.worlds(free_low_port(), 3)
    ran2, local_ran2, outcomes2 = [], [], {}
    threads2 = [_spawn_worker(P, w, _shard_fn(P, ran=ran2), reqs, outcomes=outcomes2) for w in (w1b, w2b)]
    pending = [q for q in reqs if q.row_id not in survived]
    outcome = P.dphost.run_dp_coordinator(
        cw2, _shard_fn(P, ran=local_ran2), P.dphost.shard_requests(pending, 0, 3),
        on_result=merge, done_rows=set(survived), requests=pending,
    )
    _join_all(threads2, timeout=60)
    return {
        "outcome": outcome, "workers_replayed": bool(ran2),
        "no_rerun": not (set(ran2) | set(local_ran2)) & survived,
        "merged": merge.assert_complete_no_dups(96),
    }


def test_coordinator_crash_mid_round_resume_replays_only_missing():
    """Rank 0 dies mid-round; a restarted coordinator resumes with the
    merged set and the workers re-run only rows that never merged."""
    got = both(_coordinator_crash)
    assert got["outcome"] == "completed" and got["workers_replayed"] and got["no_rerun"]


# ---------------------------------------------------------------------------
# satellites: config knobs, seeded backoff, resume bind retry, state unit
# ---------------------------------------------------------------------------


def _channel_knobs(P, port, monkeypatch):
    cfg = importlib.import_module(f"{P.root}.engine.config")
    ecfg = cfg.EngineConfig()
    got = {"defaults": (ecfg.dp_stall_timeout, ecfg.dp_heartbeat)}
    monkeypatch.delenv("SUTRO_DP_STALL_TIMEOUT", raising=False)
    monkeypatch.delenv("SUTRO_DP_HEARTBEAT", raising=False)
    P.dphost.configure_channel(stall_timeout=5.0, heartbeat=7.0)
    got["configured"] = (P.dphost._stall_timeout_s(), P.dphost._heartbeat_s())
    # the environment (set and non-empty) overrides the configured value
    monkeypatch.setenv("SUTRO_DP_STALL_TIMEOUT", "9")
    got["env"] = P.dphost._stall_timeout_s()
    with pytest.raises(ValueError, match=">= 0"):
        P.dphost.configure_channel(stall_timeout=-1.0)
    with pytest.raises(ValueError, match=">= 0"):
        P.dphost.configure_channel(heartbeat=-0.5)
    monkeypatch.delenv("SUTRO_DP_STALL_TIMEOUT")
    return got


def test_engine_config_channel_fields_and_env_precedence(monkeypatch):
    got = both(_channel_knobs, monkeypatch)
    assert got == {"defaults": (600.0, 20.0), "configured": (5.0, 7.0), "env": 9.0}


def _reconnect_delay(P, port):
    P.faults.install(P.faults.parse_plan("seed=42;row.decode:error:p=0"))
    a = [P.dphost._reconnect_delay(k, 1) for k in range(4)]
    b = [P.dphost._reconnect_delay(k, 1) for k in range(4)]
    P.faults.install(P.faults.parse_plan("seed=43;row.decode:error:p=0"))
    c = [P.dphost._reconnect_delay(k, 1) for k in range(4)]
    P.faults.clear()
    for k, v in enumerate(a):
        base = min(0.25 * 2.0 ** k, 5.0)
        assert 0.5 * base <= v < 1.5 * base
    d = P.dphost._reconnect_delay(2, 1)  # no plan: still bounded
    assert 0.5 <= d < 1.5
    return {"seeded": a, "replays": a == b, "differs": a != c}


def test_reconnect_delay_seeded_by_fault_plan():
    """Under a plan the reconnect jitter derives from the plan's seed —
    the same delays in both packages."""
    got = both(_reconnect_delay)
    assert got["replays"] and got["differs"]


def _resume_port_busy(P, port, monkeypatch):
    monkeypatch.setenv("SUTRO_DP_RESUME_BIND_RETRIES", "2")
    blocker = socket.create_server(("127.0.0.1", port))
    try:
        cw = P.dphost.DPWorld(rank=0, world=2, host="127.0.0.1", port=port)
        t0 = time.monotonic()
        served = P.dphost.serve_resume_round(cw, job_key="k", done_rows={0})
        return {"served": served, "bounded": time.monotonic() - t0 < 10}
    finally:
        blocker.close()


def test_serve_resume_round_port_busy_returns_false(monkeypatch):
    """A busy port is a bounded failure reported as False."""
    assert both(_resume_port_busy, monkeypatch) == {"served": False, "bounded": True}


def _requeue_limit(P, port):
    dp = P.dphost
    est = dp._ElasticState.build(
        _reqs(P, 8), set(), dp.shard_requests(_reqs(P, 8), 0, 2),
        dp.DPWorld(rank=0, world=2, host="", port=0),
        steal_after=180.0, join_grace=60.0, requeue_limit=1, now=0.0,
    )
    for _ in range(3):
        rank, rows, _evts = est.admit(1, True)
        assert rows == {1, 3, 5, 7} - est.done
        evts = est.release(1, "worker connection lost")
        assert evts and evts[0]["event"] == "dp_rows_requeued"
        est.rank_rows[1] = set(est.pending)
        est.pending.clear()
    return {"fatal": est.fatal}


def test_requeue_limit_fails_round_resumably():
    """A row requeued past SUTRO_DP_REQUEUE_LIMIT fails the round
    resumably instead of an endless heal loop."""
    got = both(_requeue_limit)
    assert "requeued more than 1" in got["fatal"]


def _elastic_state(P, port):
    dp = P.dphost
    est = dp._ElasticState.build(
        _reqs(P, 8), {0}, dp.shard_requests(_reqs(P, 8), 0, 2),
        dp.DPWorld(rank=0, world=2, host="", port=0),
        steal_after=180.0, join_grace=60.0, requeue_limit=3, now=0.0,
    )
    est.admit(1, True)
    got = {
        "first": est.on_res(1, 1, False),
        "dup": est.on_res(0, 1, False),  # a duplicate is dropped
        "dup_dropped": est.dup_dropped,
        # a cancelled result merges but never marks its row done
        "cancelled": est.on_res(1, 3, True), "3_done": 3 in est.done,
    }
    evts = est.drain(1, [3, 5, 7])
    got.update(
        drain=any(e["event"] == "dp_preempt_drain" for e in evts),
        requeue_count=dict(est.requeue_count),  # a drain is not counted
        pending=sorted(est.pending),
    )
    return got


def test_elastic_state_first_result_wins_and_drain_not_counted():
    got = both(_elastic_state)
    assert got["first"] is True and got["dup"] is False and got["dup_dropped"] == 1
    assert got["cancelled"] is True and got["3_done"] is False
    assert got["drain"] is True and got["requeue_count"] == {}
    assert {3, 5, 7} <= set(got["pending"])


def _fleet_view_during_local_shard(P, port):
    """Rank 0's own shard waits until the worker's rows have all merged,
    then reads the live fleet view 1.5 s later."""
    cw, w1 = P.worlds(port, 2)
    reqs = _reqs(P, 32)
    merge, seen = _Merge(), {}
    t = _spawn_worker(P, w1, _shard_fn(P), reqs)

    def local(shard, on_result, on_progress, should_cancel):
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            with merge.lock:
                if sum(r % 2 for r in merge.results) == 16:
                    break
            time.sleep(0.01)
        time.sleep(1.5)
        snap = P.dphost.fleet_view("job-live")
        seen.update(done=snap["rows"]["done"], rank1_remaining=snap["ranks"]["1"]["rows_remaining"])
        return _shard_fn(P)(shard, on_result, on_progress, should_cancel)

    outcome = P.dphost.run_dp_coordinator(
        cw, local, P.dphost.shard_requests(reqs, 0, 2),
        on_result=merge, requests=reqs, job_id="job-live",
    )
    _join_all([t])
    return {"outcome": outcome, "merged": merge.assert_complete_no_dups(32), **seen}


def test_fleet_view_is_live_while_rank0_runs_its_shard():
    """The port's coordinator republishes the fleet view every second
    for the whole round, so a watcher sees a worker's merged rows while
    rank 0 is still on its own shard (serve 10 of ``chip_smoke.py``
    kills a rank on that reading). The JAX package's view stays at the
    round's opening snapshot until rank 0's shard is done."""
    from tests.conftest import free_low_port

    port = _fleet_view_during_local_shard(Pkg("sutro_tpu_torch"), free_low_port())
    assert port == {"outcome": "completed", "merged": list(range(32)),
                    "done": 16, "rank1_remaining": 0}
    ref = _fleet_view_during_local_shard(Pkg("sutro_tpu"), free_low_port())
    assert ref["outcome"] == "completed" and (ref["done"], ref["rank1_remaining"]) == (0, 16)
