"""Lock-light metrics registry: counters, gauges, bounded histograms.

The reference SDK has no metrics at all — progress/usage accounting
lives behind the hosted service (SURVEY §0). The TPU-native engine
replaces that fleet, so it also needs the fleet's eyes: cheap,
always-on process metrics an operator can scrape.

Design constraints (the hot paths this serves are the scheduler's
decode loop and the jobstore's flush path):

- **Writes never contend.** Every writer thread accumulates into its
  own thread-local shard (a plain dict keyed by ``(metric, labels)``);
  an increment is a dict get/set — no lock, no atomics beyond the GIL.
  Readers aggregate across shards at collect time; shards of dead
  threads fold into a retired base so a daemon that spawns per-job
  threads stays bounded.
- **Fixed label cardinality.** Metrics declare their label names up
  front, and each metric admits at most ``max_series`` distinct label
  value tuples; overflow collapses into a single ``"_overflow"``
  series instead of growing without bound. Job ids and other unbounded
  identifiers therefore never become labels — per-job numbers live in
  the flight recorder's per-job counters (telemetry/__init__.py).
- **Bounded histogram buckets.** Fixed boundaries chosen at
  declaration; observation is a bisect + two adds.

Exporters: Prometheus text exposition (0.0.4) via
:meth:`MetricsRegistry.to_prometheus` and a JSON snapshot via
:meth:`MetricsRegistry.to_json`. Both produce deterministic ordering
(sorted by metric name, then label values) so goldens are stable.

Federation (telemetry/distributed.py): a dp worker exports a compact
local snapshot (:meth:`MetricsRegistry.export_snapshot`), ships the
per-round difference (:func:`snapshot_delta`) over the dp channel, and
the coordinator folds it in with :meth:`MetricsRegistry.ingest_remote`.
Ingested series keep their metric identity but gain a trailing
``worker`` label (the coordinator's own series export as worker "0");
metrics with no remote contribution export exactly as before, so
single-process goldens are unaffected. Worker-label cardinality is
bounded like any label (overflow collapses into ``_overflow``).
"""

from __future__ import annotations

import bisect
import logging
import math
import threading
import time as _time
from typing import Any, Dict, List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)

# default latency buckets (seconds): 100us .. ~100s, log-ish spacing —
# covers tokenize batches, decode windows, flushes and finalizes alike
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 100.0,
)

_OVERFLOW = ("_overflow",)


class _Shard:
    """One thread's private accumulators. Only its owner thread writes;
    readers only ever sum snapshots, so a torn read costs at most a
    momentarily-stale value, never corruption."""

    __slots__ = ("counters", "hists")

    def __init__(self) -> None:
        # (metric_name, label_values) -> float
        self.counters: Dict[Tuple[str, Tuple[str, ...]], float] = {}
        # (metric_name, label_values) -> [bucket_counts..., sum, count]
        self.hists: Dict[Tuple[str, Tuple[str, ...]], List[float]] = {}


class _Metric:
    """Common metric definition: name, kind, help, unit, label names."""

    def __init__(
        self,
        registry: "MetricsRegistry",
        name: str,
        kind: str,
        help_: str,
        labels: Sequence[str],
        unit: str,
        max_series: int,
    ) -> None:
        self.registry = registry
        self.name = name
        self.kind = kind
        self.help = help_
        self.label_names = tuple(labels)
        self.unit = unit
        self.max_series = max_series
        # label tuples this metric has admitted (reads are GIL-safe;
        # admission of a NEW tuple takes the registry lock)
        self._series: set = set()

    def _labelvals(self, labels: Tuple[str, ...]) -> Tuple[str, ...]:
        """Admit a label tuple under the cardinality cap (overflow
        collapses). Hot calls hit the membership test only."""
        if labels in self._series:
            return labels
        overflow = _OVERFLOW * len(self.label_names)
        with self.registry._lock:
            if labels in self._series:
                return labels
            if len(self._series) >= self.max_series:
                self._series.add(overflow)
                return overflow
            self._series.add(labels)
        return labels

    def _check(self, labels: Tuple[str, ...]) -> None:
        if len(labels) != len(self.label_names):
            raise ValueError(
                f"{self.name} takes labels {self.label_names}, "
                f"got {labels!r}"
            )


class Counter(_Metric):
    def inc(self, n: float = 1.0, *labels: str) -> None:
        lv = tuple(str(x) for x in labels)
        self._check(lv)
        lv = self._labelvals(lv)
        c = self.registry._shard().counters
        key = (self.name, lv)
        c[key] = c.get(key, 0.0) + n


class Gauge(_Metric):
    """Last-write-wins value. Stored registry-global (not sharded):
    a gauge is a statement about *now*, so per-thread accumulation
    would be meaningless. A plain dict assignment is GIL-atomic."""

    def set(self, value: float, *labels: str) -> None:
        lv = tuple(str(x) for x in labels)
        self._check(lv)
        lv = self._labelvals(lv)
        self.registry._gauges[(self.name, lv)] = float(value)


class Histogram(_Metric):
    #: recency bias: a stored exemplar older than this loses its slot
    #: to ANY new observation in the bucket, even a smaller one
    EXEMPLAR_MAX_AGE_S = 60.0

    def __init__(self, *args: Any, buckets: Sequence[float] = DEFAULT_BUCKETS,
                 **kw: Any) -> None:
        super().__init__(*args, **kw)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        # exemplars: (label_values, bucket_idx) ->
        #   (value, trace_id, attrs_or_None, unix_ts). One slot per
        # bucket per series — bounded by construction (buckets x
        # max_series). Stored registry-global, not in thread shards:
        # an exemplar must survive shard folding and read identically
        # from every concurrent scrape. Single dict assignment per
        # capture (GIL-atomic), no lock.
        self._exemplars: Dict[Tuple[Tuple[str, ...], int], tuple] = {}

    def observe(
        self,
        value: float,
        *labels: str,
        exemplar: Optional[str] = None,
        exemplar_attrs: Optional[Dict[str, str]] = None,
        _now: Optional[float] = None,
    ) -> None:
        lv = tuple(str(x) for x in labels)
        self._check(lv)
        lv = self._labelvals(lv)
        h = self.registry._shard().hists
        key = (self.name, lv)
        acc = h.get(key)
        if acc is None:
            acc = h[key] = [0.0] * (len(self.buckets) + 3)
        # layout: [b0..bn, +Inf, sum, count]
        idx = bisect.bisect_left(self.buckets, value)
        acc[idx] += 1.0
        acc[-2] += value
        acc[-1] += 1.0
        if exemplar is not None:
            self._capture_exemplar(
                lv, idx, value, exemplar, exemplar_attrs, _now
            )

    def _capture_exemplar(
        self,
        lv: Tuple[str, ...],
        idx: int,
        value: float,
        trace_id: str,
        attrs: Optional[Dict[str, str]],
        now: Optional[float],
    ) -> None:
        """Latency/recency-biased keep policy: within a bucket the
        slot goes to the LARGEST value seen recently — a stale holder
        (older than EXEMPLAR_MAX_AGE_S) yields to any newcomer, so a
        one-off spike from an hour ago cannot pin the slot forever."""
        ts = _time.time() if now is None else now
        cur = self._exemplars.get((lv, idx))
        if cur is not None:
            if value < cur[0] and (ts - cur[3]) < self.EXEMPLAR_MAX_AGE_S:
                return
        self._exemplars[(lv, idx)] = (
            float(value), str(trace_id),
            dict(attrs) if attrs else None, ts,
        )

    def exemplars_view(self) -> Dict[Tuple[str, ...], Dict[str, Dict]]:
        """Snapshot ``{label_values: {le_str: exemplar_dict}}`` where
        ``exemplar_dict`` is ``{value, trace_id, ts[, attrs]}`` —
        the JSON-snapshot shape, also what the exporter renders."""
        les = [*self.buckets, math.inf]
        out: Dict[Tuple[str, ...], Dict[str, Dict]] = {}
        for (lv, idx), (value, trace_id, attrs, ts) in sorted(
            self._exemplars.items()
        ):
            le = les[idx]
            le_s = "+Inf" if math.isinf(le) else repr(le)
            d: Dict[str, Any] = {
                "value": value, "trace_id": trace_id, "ts": ts,
            }
            if attrs:
                d["attrs"] = dict(attrs)
            out.setdefault(lv, {})[le_s] = d
        return out


class MetricsRegistry:
    #: worker-label cardinality cap for federation (ingest_remote):
    #: shards from more distinct workers collapse into "_overflow"
    MAX_WORKERS = 64

    def __init__(self, federation_label: str = "worker") -> None:
        # the trailing label federated series gain: "worker" for the dp
        # coordinator (the historical default, pinned by dp goldens),
        # "replica" for the fleet router's federated registry
        self.federation_label = federation_label
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}
        self._gauges: Dict[Tuple[str, Tuple[str, ...]], float] = {}
        self._local = threading.local()
        # (thread, shard) pairs; dead threads' shards fold into _retired
        self._shards: List[Tuple[threading.Thread, _Shard]] = []
        self._retired = _Shard()
        # federation: worker id -> accumulated remote series
        # (telemetry/distributed.py coordinator ingestion). Counters and
        # histograms ACCUMULATE across ingests (workers ship per-round
        # deltas); gauges are last-write-wins per worker.
        self._remote: Dict[str, Dict[str, Dict]] = {}

    # -- declaration ---------------------------------------------------

    def _declare(self, cls, name: str, help_: str, labels: Sequence[str],
                 unit: str, max_series: int, **kw: Any):
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls):
                    raise ValueError(
                        f"metric {name} already declared as "
                        f"{existing.kind}"
                    )
                return existing
            m = cls(self, name, cls.__name__.lower(), help_, labels,
                    unit, max_series, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help_: str = "",
                labels: Sequence[str] = (), unit: str = "",
                max_series: int = 64) -> Counter:
        return self._declare(Counter, name, help_, labels, unit,
                             max_series)

    def gauge(self, name: str, help_: str = "",
              labels: Sequence[str] = (), unit: str = "",
              max_series: int = 64) -> Gauge:
        return self._declare(Gauge, name, help_, labels, unit,
                             max_series)

    def histogram(self, name: str, help_: str = "",
                  labels: Sequence[str] = (), unit: str = "",
                  max_series: int = 64,
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._declare(Histogram, name, help_, labels, unit,
                             max_series, buckets=buckets)

    # -- shards --------------------------------------------------------

    def _shard(self) -> _Shard:
        s = getattr(self._local, "shard", None)
        if s is None:
            s = _Shard()
            self._local.shard = s
            with self._lock:
                self._shards.append((threading.current_thread(), s))
        return s

    def _merge_shard(self, into: _Shard, s: _Shard) -> None:
        for k, v in list(s.counters.items()):
            into.counters[k] = into.counters.get(k, 0.0) + v
        for k, acc in list(s.hists.items()):
            base = into.hists.get(k)
            if base is None:
                into.hists[k] = list(acc)
            else:
                for i, v in enumerate(list(acc)):
                    if i < len(base):
                        base[i] += v

    def _aggregate(self) -> _Shard:
        """Sum every live shard over the retired base. Dead threads'
        shards fold into the retired base and drop from the live list
        (keeps a long-lived daemon's shard list bounded by its LIVE
        thread count)."""
        with self._lock:
            live = []
            for t, s in self._shards:
                if t.is_alive():
                    live.append((t, s))
                else:
                    self._merge_shard(self._retired, s)
            self._shards = live
            out = _Shard()
            self._merge_shard(out, self._retired)
            shards = [s for _, s in live]
        for s in shards:
            self._merge_shard(out, s)
        return out

    # -- collection / export -------------------------------------------

    @staticmethod
    def _hist_view(m: "Histogram", acc: Sequence[float]) -> Dict[str, Any]:
        les = [*m.buckets, math.inf]
        return {
            "buckets": {
                ("+Inf" if math.isinf(le) else repr(le)): int(
                    sum(acc[: i + 1])
                )
                for i, le in enumerate(les)
            },
            "sum": acc[-2],
            "count": int(acc[-1]),
        }

    def collect(self) -> Dict[str, Dict[str, Any]]:
        """Aggregated snapshot:
        ``{name: {type, help, unit, labels, series: {"a,b": value}}}``
        — histogram series values are
        ``{buckets: {le: n}, sum, count}``.

        When remote worker shards have been ingested (federation), any
        metric with a remote contribution gains a trailing ``worker``
        label: its local series carry worker "0", remote series carry
        their worker id. Metrics without remote data are unchanged."""
        agg = self._aggregate()
        with self._lock:
            metrics = dict(self._metrics)
            remote = {
                w: {
                    kind: dict(series)
                    for kind, series in shard.items()
                }
                for w, shard in self._remote.items()
            }
        gauges = dict(self._gauges)
        remote_names = {
            n
            for shard in remote.values()
            for series in shard.values()
            for (n, _lv) in series
        }
        out: Dict[str, Dict[str, Any]] = {}
        for name in sorted(metrics):
            m = metrics[name]
            federated = name in remote_names
            entry: Dict[str, Any] = {
                "type": m.kind,
                "help": m.help,
                "unit": m.unit,
                "labels": list(m.label_names)
                + ([self.federation_label] if federated else []),
                "series": {},
            }
            if isinstance(m, Gauge):
                src: Dict[Tuple[str, ...], Any] = {
                    lv: v for (n, lv), v in gauges.items() if n == name
                }
            elif isinstance(m, Histogram):
                src = {
                    lv: self._hist_view(m, acc)
                    for (n, lv), acc in agg.hists.items()
                    if n == name
                }
            else:
                src = {
                    lv: v
                    for (n, lv), v in agg.counters.items()
                    if n == name
                }
            if federated:
                src = {lv + ("0",): v for lv, v in src.items()}
                kind = (
                    "gauges" if isinstance(m, Gauge)
                    else "hists" if isinstance(m, Histogram)
                    else "counters"
                )
                for w in sorted(remote):
                    for (n, lv), v in remote[w].get(kind, {}).items():
                        if n != name:
                            continue
                        if isinstance(m, Histogram):
                            v = self._hist_view(m, v)
                        src[lv + (w,)] = v
            for lv in sorted(src):
                entry["series"][",".join(lv)] = src[lv]
            if isinstance(m, Histogram):
                ex = m.exemplars_view()
                if ex:
                    # key shape matches "series" keys for the local
                    # (non-federated) case; federation ships no
                    # exemplars — the exporter maps worker-"0" series
                    # back to these local keys
                    entry["exemplars"] = {
                        ",".join(lv): d for lv, d in sorted(ex.items())
                    }
            out[name] = entry
        return out

    def exemplars(self, name: str) -> List[Dict[str, Any]]:
        """Flat exemplar list for one histogram, largest value first —
        what the monitor embeds into an alert event (top trace ids)."""
        m = self._metrics.get(name)
        if not isinstance(m, Histogram):
            return []
        out: List[Dict[str, Any]] = []
        for lv, by_le in m.exemplars_view().items():
            for le_s, d in by_le.items():
                row = dict(d)
                row["le"] = le_s
                row["labels"] = list(lv)
                out.append(row)
        out.sort(key=lambda d: (-d["value"], d["trace_id"]))
        return out

    # -- federation (telemetry/distributed.py) -------------------------

    def export_snapshot(self) -> Dict[str, List]:
        """Compact JSON-able snapshot of this process's OWN series
        (remote ingested data excluded on purpose: a worker's export
        must never echo back shards it was federated). Shape:
        ``{"counters": [[name, [labels...], value], ...],
           "hists":    [[name, [labels...], [acc...]], ...],
           "gauges":   [[name, [labels...], value], ...]}``."""
        agg = self._aggregate()
        gauges = dict(self._gauges)
        return {
            "counters": [
                [n, list(lv), v]
                for (n, lv), v in sorted(agg.counters.items())
            ],
            "hists": [
                [n, list(lv), list(acc)]
                for (n, lv), acc in sorted(agg.hists.items())
            ],
            "gauges": [
                [n, list(lv), v] for (n, lv), v in sorted(gauges.items())
            ],
        }

    def ingest_remote(self, worker: str, shard: Dict[str, Any]) -> None:
        """Fold one remote shard (a worker's :func:`snapshot_delta`)
        into the federation store under ``worker``. Unknown metric
        names and malformed entries are skipped (wire-version drift must
        degrade, not raise); histogram entries whose accumulator length
        does not match this process's bucket schema are skipped too.
        Counter/histogram values ACCUMULATE across ingests; gauges are
        last-write-wins."""
        if not isinstance(shard, dict):
            return
        with self._lock:
            w = str(worker)
            if w not in self._remote and len(self._remote) >= self.MAX_WORKERS:
                w = "_overflow"
            rs = self._remote.setdefault(
                w, {"counters": {}, "hists": {}, "gauges": {}}
            )
            for kind in ("counters", "hists", "gauges"):
                for item in shard.get(kind) or ():
                    try:
                        name, lv, v = item
                        m = self._metrics.get(str(name))
                        if m is None:
                            continue
                        lv = tuple(str(x) for x in lv)
                        if len(lv) != len(m.label_names):
                            continue
                        key = (m.name, lv)
                        dst = rs[kind]
                        if kind == "hists":
                            if not isinstance(m, Histogram) or len(v) != (
                                len(m.buckets) + 3
                            ):
                                continue
                            base = dst.get(key)
                            if base is None:
                                dst[key] = [float(x) for x in v]
                            else:
                                for i, x in enumerate(v):
                                    base[i] += float(x)
                        elif kind == "counters":
                            if not isinstance(m, Counter):
                                continue
                            dst[key] = dst.get(key, 0.0) + float(v)
                        else:
                            if not isinstance(m, Gauge):
                                continue
                            dst[key] = float(v)
                    except (TypeError, ValueError) as e:
                        logger.debug(
                            "skipping malformed remote series %r: %s",
                            item, e,
                        )

    @staticmethod
    def _fmt_labels(names: Sequence[str], values: Sequence[str],
                    extra: Optional[Tuple[str, str]] = None) -> str:
        def esc(v: str) -> str:
            return (
                v.replace("\\", "\\\\")
                .replace('"', '\\"')
                .replace("\n", "\\n")
            )

        pairs = list(zip(names, values))
        if extra is not None:
            pairs.append(extra)
        if not pairs:
            return ""
        body = ",".join(f'{k}="{esc(v)}"' for k, v in pairs)
        return "{" + body + "}"

    @staticmethod
    def _fmt_value(v: float) -> str:
        if v == int(v) and abs(v) < 1e15:
            return str(int(v))
        return repr(float(v))

    @classmethod
    def _fmt_exemplar(cls, ex: Dict[str, Any]) -> str:
        """OpenMetrics exemplar suffix for a ``_bucket`` line:
        `` # {trace_id="...",k="v"} value timestamp``."""
        names = ["trace_id"]
        values = [str(ex["trace_id"])]
        for k in sorted(ex.get("attrs") or ()):
            names.append(str(k))
            values.append(str(ex["attrs"][k]))
        return (
            " # "
            + cls._fmt_labels(names, values)
            + f" {cls._fmt_value(ex['value'])}"
            + f" {cls._fmt_value(float(ex['ts']))}"
        )

    def to_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        snap = self.collect()
        lines: List[str] = []
        for name, m in snap.items():
            lines.append(f"# HELP {name} {m['help']}")
            lines.append(f"# TYPE {name} {m['type']}")
            names = m["labels"]
            ex_map = m.get("exemplars") or {}
            for key, val in m["series"].items():
                values = tuple(key.split(",")) if names else ()
                if m["type"] == "histogram":
                    ex_series = ex_map.get(key)
                    if (
                        ex_series is None
                        and names
                        and names[-1] == self.federation_label
                        and values[-1:] == ("0",)
                    ):
                        # federated metric: exemplars live on the
                        # coordinator's own (worker "0") series
                        ex_series = ex_map.get(",".join(values[:-1]))
                    for le, n in val["buckets"].items():
                        le_s = le if le == "+Inf" else self._fmt_value(
                            float(le)
                        )
                        line = (
                            f"{name}_bucket"
                            + self._fmt_labels(names, values,
                                               ("le", le_s))
                            + f" {n}"
                        )
                        ex = (ex_series or {}).get(le)
                        if ex is not None:
                            line += self._fmt_exemplar(ex)
                        lines.append(line)
                    lines.append(
                        f"{name}_sum"
                        + self._fmt_labels(names, values)
                        + f" {self._fmt_value(val['sum'])}"
                    )
                    lines.append(
                        f"{name}_count"
                        + self._fmt_labels(names, values)
                        + f" {val['count']}"
                    )
                else:
                    lines.append(
                        name
                        + self._fmt_labels(names, values)
                        + f" {self._fmt_value(val)}"
                    )
        return "\n".join(lines) + ("\n" if lines else "")

    def to_json(self) -> Dict[str, Any]:
        return self.collect()

    def reset(self) -> None:
        """Test hook: drop every accumulated value (declarations stay).
        Not for production use — concurrent writers may keep shards the
        reset has already cleared."""
        with self._lock:
            self._retired = _Shard()
            self._shards = []
            self._gauges.clear()
            self._remote.clear()
            self._local = threading.local()
            for m in self._metrics.values():
                m._series = set()
                if isinstance(m, Histogram):
                    m._exemplars = {}


def snapshot_delta(
    before: Dict[str, List], after: Dict[str, List]
) -> Dict[str, List]:
    """Difference of two :meth:`MetricsRegistry.export_snapshot` calls
    — what a dp worker ships per round. Counters/histograms subtract
    (series that did not move are dropped); gauges pass through as
    their CURRENT values (a gauge is a statement about now, a gauge
    delta is meaningless)."""

    def _index(snap, kind):
        return {
            (name, tuple(lv)): v
            for name, lv, v in (snap.get(kind) or ())
        }

    out: Dict[str, List] = {"counters": [], "hists": [], "gauges": []}
    base = _index(before, "counters")
    for (name, lv), v in sorted(_index(after, "counters").items()):
        d = v - base.get((name, lv), 0.0)
        if d > 0:
            out["counters"].append([name, list(lv), d])
    base = _index(before, "hists")
    for (name, lv), acc in sorted(_index(after, "hists").items()):
        b = base.get((name, lv))
        d = (
            list(acc)
            if b is None or len(b) != len(acc)
            else [x - y for x, y in zip(acc, b)]
        )
        if d and d[-1] > 0:  # count moved
            out["hists"].append([name, list(lv), d])
    out["gauges"] = [
        [name, list(lv), v]
        for (name, lv), v in sorted(_index(after, "gauges").items())
    ]
    return out
