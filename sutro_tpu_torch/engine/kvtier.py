"""Tiered paged-KV pool: HBM -> pinned host RAM -> disk.

The port of ``sutro_tpu/engine/kvtier.py`` (numpy only; the int8 math is
the reference's byte for byte, so the same payload demoted in either
package gives the same int8 values and scales).

Every byte of warm state
used to live in one device's HBM, so resident capacity — and resume
latency for anything that fell out — was hard-capped by device KV.
This module owns the two tiers BELOW the device pool and the bounded
migration worker that moves page payloads between them:

- **host tier** — an LRU dict of page payloads, always stored int8
  (quantize-on-demote via the same math as ``kvcache._quantize_tokens``,
  regardless of the HBM pool dtype) so a host-RAM byte holds 2x the
  bf16 tokens. Budgeted in pages (``host_pages``).
- **disk tier** — one ``.npz`` bundle per entry under ``disk_dir``,
  written with the jobstore partial-store idiom (tmp + atomic rename;
  torn files quarantined to ``.corrupt/`` on read, never crashing the
  reader). Host-tier overflow spills here; entries survive the process.

The pool stores PAYLOADS, not device pages: entries are keyed by the
raw bytes of the FULL token prefix whose KV they hold (prefix pages) or
by an opaque hibernation key (suspended rows), so promotion is exact —
KV depends on (tokens, positions) only, and a byte-equal key guarantees
a bit-identical (up to int8 round-trip) page. Device-side ownership
never enters this module: the scheduler reads pages out of the runner
BEFORE freeing them and uploads into freshly allocated pages on
promote.

Migration worker: demotions are staged synchronously (the raw payload
is already a host copy) and quantized/spilled asynchronously on one
bounded daemon thread — the scheduler hot path never waits on a disk
write. ``drain()`` flushes the queue for deterministic tests.

Torn-migration contract (chaos suite, FAILURES.md):

- a torn DEMOTION (fault site ``kvtier.demote``) drops the entry — the
  HBM copy (or the request itself) stays authoritative, degrading to a
  plain eviction / full regenerate, never to corruption;
- a torn PROMOTION (``kvtier.promote``) retries once, then returns
  None — the caller re-prefills the tokens it asked for;
- a torn DISK WRITE (``kvtier.disk_write``) leaves the host copy in
  place (durability is best-effort; the host tier stays authoritative
  until the rename lands), and a torn file on disk is quarantined at
  read time.

Kill switch: the pool only exists when ``EngineConfig.kv_tiers`` is on
and ``SUTRO_KV_TIERS`` is not ``0``/``off`` — the scheduler holds None
otherwise and runs the untiered path bit-identically with zero tier
ops (asserted by tests/test_torch_kv_tiers.py).
"""

from __future__ import annotations

import hashlib
import logging
import queue
import threading
from collections import OrderedDict
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import telemetry
from . import faults

logger = logging.getLogger("sutro.kvtier")

# payload dict keys: int8 values + f32 per-token scales, [L, n, PS, KD]
# and [L, n, PS] — the canonical below-HBM page format
_PAYLOAD_KEYS = ("k", "v", "ks", "vs")


def quantize_payload(raw: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Raw page payload (any float dtype, or already int8+scales) ->
    canonical int8 payload. The math is kvcache._quantize_tokens
    verbatim (f32 amax / 127, 1e-8 floor, symmetric clip) so a
    demote->promote round trip through a bf16 pool drifts no more than
    the round-4 ``kv_quantize="int8"`` bound."""
    if raw["k"].dtype == np.int8:
        return raw  # int8 pool: already values+scales, bit-exact
    out: Dict[str, np.ndarray] = {}
    for vk, sk in (("k", "ks"), ("v", "vs")):
        xf = np.asarray(raw[vk], np.float32)
        amax = np.max(np.abs(xf), axis=-1)
        scale = np.maximum(amax / 127.0, 1e-8)
        q = np.clip(np.rint(xf / scale[..., None]), -127, 127)
        out[vk] = q.astype(np.int8)
        out[sk] = scale.astype(np.float32)
    return out


def dequantize_payload(
    payload: Dict[str, np.ndarray], dtype
) -> Dict[str, np.ndarray]:
    """Canonical int8 payload -> float values in ``dtype`` (promotion
    into an unquantized HBM pool)."""
    return {
        "k": (
            payload["k"].astype(np.float32) * payload["ks"][..., None]
        ).astype(dtype),
        "v": (
            payload["v"].astype(np.float32) * payload["vs"][..., None]
        ).astype(dtype),
    }


class _Entry:
    __slots__ = ("payload", "n_pages", "pin")

    def __init__(self, payload: Dict[str, np.ndarray], pin: bool):
        self.payload = payload
        self.n_pages = int(payload["k"].shape[1])
        self.pin = pin  # pinned entries (hibernated rows) never DROP —
        #                 they may spill to disk, but only durably


class KVTierPool:
    """Host + disk tiers for paged-KV payloads, engine-lifetime."""

    def __init__(
        self,
        page_size: int,
        *,
        host_pages: int = 4096,
        disk_dir: Optional[Path] = None,
        queue_depth: int = 256,
    ):
        self.page_size = int(page_size)
        self.host_pages = int(host_pages)
        self.disk_dir = Path(disk_dir) if disk_dir is not None else None
        self._lock = threading.RLock()
        self._host: "OrderedDict[bytes, _Entry]" = OrderedDict()
        self._staging: Dict[bytes, Tuple[Dict[str, np.ndarray], bool]] = {}
        self._disk: Dict[bytes, int] = {}  # key -> n_pages on disk
        self._host_used = 0
        self._closed = False
        # demote requests posted by the gateway's idle-session
        # checkpointer; drained by the live batcher at a safe point
        # (it owns the allocator the freed pages return to)
        self._demote_req: "queue.SimpleQueue[np.ndarray]" = (
            queue.SimpleQueue()
        )
        # exact op census (tests + profile_host_overhead assert ZERO of
        # everything with the kill switch off)
        self.demotes = 0
        self.promotes = 0
        self.disk_writes = 0
        self.disk_reads = 0
        self.dropped = 0  # torn/overflowed migrations (never pinned)
        # bounded migration worker: the scheduler never blocks on
        # quantization or a disk write
        self._q: "queue.Queue[Optional[bytes]]" = queue.Queue(
            maxsize=max(8, int(queue_depth))
        )
        self._inflight = 0
        self._idle = threading.Condition(self._lock)
        if self.disk_dir is not None:
            try:
                self.disk_dir.mkdir(parents=True, exist_ok=True)
                self._scan_disk()
            except OSError:
                logger.warning(
                    "kv tier disk dir unusable; disk tier off",
                    exc_info=True,
                )
                self.disk_dir = None
        # the worker starts only once the disk tier is decided: it
        # reads ``disk_dir``/``_disk`` without the lock, so both must
        # be fully published before the thread exists (the old order
        # let the OSError fallback above race the first migration)
        self._worker = threading.Thread(
            target=self._run_worker, daemon=True, name="sutro-kv-migrate"
        )
        self._worker.start()

    # -- key helpers ----------------------------------------------------

    @staticmethod
    def prefix_key(tokens: np.ndarray) -> bytes:
        """Content key for a prefix page: the raw bytes of the FULL
        token prefix through that page (causal attention: a page's KV
        is only valid joined with every ancestor token)."""
        return np.ascontiguousarray(
            np.asarray(tokens, np.int32)
        ).tobytes()

    # -- demotion (device -> host) --------------------------------------

    def put_page(self, key: bytes, raw: Dict[str, np.ndarray]) -> None:
        """Stage one demoted PREFIX page asynchronously. ``raw`` is the
        runner's host copy (any pool dtype); the worker quantizes and
        inserts. Lossy by design: a full queue or a torn demotion drops
        the entry (plain eviction), never blocks the scheduler."""
        with self._lock:
            if self._closed or key in self._host or key in self._staging:
                return
            self._staging[key] = (raw, False)
            self._inflight += 1
        try:
            self._q.put_nowait(key)
        except queue.Full:
            with self._lock:
                self._staging.pop(key, None)
                self._inflight -= 1
                self.dropped += 1
                self._idle.notify_all()

    def put_row(self, key: bytes, raw: Dict[str, np.ndarray]) -> None:
        """Demote a HIBERNATED row's pages synchronously and pinned.
        Raises on a torn demotion (fault site ``kvtier.demote``) so the
        caller can fall back to the regenerate path BEFORE freeing the
        row's device pages — the HBM copy stays authoritative until
        this returns."""
        if faults.ACTIVE is not None:
            faults.inject("kvtier.demote")
        payload = quantize_payload(raw)
        with self._lock:
            if self._closed:
                raise RuntimeError("kv tier pool is closed")
            self._insert_host(key, _Entry(payload, pin=True))
        self._count("demote")

    # -- promotion (host/disk -> device) --------------------------------

    def get_page(self, key: bytes) -> Optional[Dict[str, np.ndarray]]:
        """Payload for ``key`` or None. Checks host, then staging (a
        demotion still in the worker queue), then disk. A torn
        promotion (fault site ``kvtier.promote``) retries once, then
        degrades to a miss — the caller re-prefills."""
        for attempt in (0, 1):
            try:
                if faults.ACTIVE is not None:
                    faults.inject("kvtier.promote")
                return self._get_once(key)
            except Exception:
                if attempt:
                    logger.warning(
                        "kv tier promote failed twice; degrading to "
                        "re-prefill", exc_info=True,
                    )
                    return None
        return None

    def take_row(self, key: bytes) -> Optional[Dict[str, np.ndarray]]:
        """Promote-and-remove a hibernated row's payload (a resumed row
        re-demotes on its next suspension; keeping the stale copy would
        serve an outdated sequence)."""
        payload = self.get_page(key)
        if payload is not None:
            self.discard([key])
        return payload

    def _get_once(self, key: bytes) -> Optional[Dict[str, np.ndarray]]:
        with self._lock:
            ent = self._host.get(key)
            if ent is not None:
                self._host.move_to_end(key)
                self._count("promote")
                return ent.payload
            staged = self._staging.get(key)
            if staged is not None:
                self._count("promote")
                return quantize_payload(staged[0])
            on_disk = key in self._disk
        if not on_disk or self.disk_dir is None:
            return None
        payload = self._disk_read(key)
        if payload is None:
            return None
        with self._lock:
            # cache the disk hit back in the host tier (it is warm now)
            if key not in self._host and not self._closed:
                self._insert_host(key, _Entry(payload, pin=False))
            self._count("promote")
        return payload

    def discard(self, keys: List[bytes]) -> None:
        """Drop entries in every tier (promoted into HBM, or a session
        reset). Missing keys are fine."""
        with self._lock:
            for key in keys:
                ent = self._host.pop(key, None)
                if ent is not None:
                    self._host_used -= ent.n_pages
                self._staging.pop(key, None)
                self._disk.pop(key, None)
            self._set_gauges()
        if self.disk_dir is not None:
            for key in keys:
                try:
                    self._disk_path(key).unlink(missing_ok=True)
                except OSError:
                    pass

    # -- gateway-side idle checkpointing --------------------------------

    def request_demote(self, tokens: np.ndarray) -> None:
        """Post a demote request for the prefix-store pages covering
        ``tokens`` (an idle session's conversation). The LIVE batcher
        drains these at its loop top — it owns the allocator that the
        freed device pages return to; with no batcher running the pages
        simply stay warm in HBM."""
        self._demote_req.put(np.asarray(tokens, np.int32))

    def pop_demote_requests(self) -> List[np.ndarray]:
        out: List[np.ndarray] = []
        while True:
            try:
                out.append(self._demote_req.get_nowait())
            except queue.Empty:
                return out

    # -- accounting -----------------------------------------------------

    def pages(self, tier: str) -> int:
        with self._lock:
            if tier == "host":
                return self._host_used + sum(
                    int(np.asarray(r["k"]).shape[1])
                    for r, _ in self._staging.values()
                )
            if tier == "disk":
                return sum(self._disk.values())
            raise ValueError(f"unknown tier {tier!r}")

    def op_census(self) -> Dict[str, int]:
        with self._lock:
            return {
                "demotes": self.demotes,
                "promotes": self.promotes,
                "disk_writes": self.disk_writes,
                "disk_reads": self.disk_reads,
                "dropped": self.dropped,
            }

    def set_host_budget(self, pages: int) -> int:
        """Re-budget the pinned-host tier live (the control plane's
        ``kv_tier_host_pages`` knob actuates through here). Shrinking
        evicts LRU entries immediately — spilled to disk when a disk
        tier exists, else unpinned entries drop; pinned entries without
        a disk tier stay resident over budget (a hibernated row is
        never lost). Returns the applied budget."""
        pages = max(1, int(pages))
        with self._lock:
            if self._closed:
                return self.host_pages
            self.host_pages = pages
            self._evict_host_locked()
            self._set_gauges()
        return pages

    def drain(self, timeout: float = 30.0) -> bool:
        """Block until the migration worker has consumed every staged
        demotion/spill (deterministic tests; engine drain)."""
        import time as _time

        deadline = _time.monotonic() + timeout
        with self._idle:
            while self._inflight > 0:
                left = deadline - _time.monotonic()
                if left <= 0:
                    return False
                self._idle.wait(min(left, 0.25))
            return True

    def close(self, timeout: float = 10.0) -> None:
        """Stop the worker with a bounded join; the host tier drops
        (its payloads die with the process anyway), disk entries stay
        for the next process."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        try:
            self._q.put_nowait(None)
        except queue.Full:
            pass
        self._worker.join(timeout=timeout)
        with self._lock:
            self._host.clear()
            self._staging.clear()
            self._host_used = 0
            self._set_gauges()

    # -- internals ------------------------------------------------------

    def _count(self, direction: str) -> None:
        with self._lock:
            if direction == "demote":
                self.demotes += 1
            elif direction == "promote":
                self.promotes += 1
            elif direction == "disk_write":
                self.disk_writes += 1
            elif direction == "disk_read":
                self.disk_reads += 1
        if telemetry.ENABLED:
            telemetry.KV_MIGRATIONS_TOTAL.inc(1.0, direction)

    def _set_gauges(self) -> None:
        # caller holds the lock
        if telemetry.ENABLED:
            telemetry.KV_TIER_PAGES.set(float(self._host_used), "host")
            telemetry.KV_TIER_PAGES.set(
                float(sum(self._disk.values())), "disk"
            )

    def _insert_host(self, key: bytes, ent: _Entry) -> None:
        # caller holds the lock
        old = self._host.pop(key, None)
        if old is not None:
            self._host_used -= old.n_pages
        self._host[key] = ent
        self._host_used += ent.n_pages
        self._evict_host_locked()
        self._set_gauges()

    def _evict_host_locked(self) -> None:
        """Shed LRU host entries over budget: spill to disk when a disk
        tier exists (durable-before-drop for pinned entries), else drop
        unpinned ones. Pinned entries without a disk tier stay resident
        over budget — a hibernated row must never be lost."""
        if self._host_used <= self.host_pages:
            return
        for key in list(self._host.keys()):
            if self._host_used <= self.host_pages:
                return
            ent = self._host[key]
            if self.disk_dir is not None:
                # durable first: the entry leaves the host tier from
                # the worker only after the rename lands
                if key not in self._disk:
                    self._staging.setdefault(
                        key, (ent.payload, ent.pin)
                    )
                    self._inflight += 1
                    try:
                        self._q.put_nowait(key)
                    except queue.Full:
                        self._staging.pop(key, None)
                        self._inflight -= 1
                        if not ent.pin:
                            del self._host[key]
                            self._host_used -= ent.n_pages
                            self.dropped += 1
                        continue
                    # optimistic: the worker completes the spill and
                    # removes the host copy; keep it until then
                    continue
                del self._host[key]
                self._host_used -= ent.n_pages
            elif not ent.pin:
                del self._host[key]
                self._host_used -= ent.n_pages
                self.dropped += 1
            # pinned + no disk: keep (bounded by live hibernated rows)

    def _run_worker(self) -> None:
        while True:
            key = self._q.get()
            if key is None:
                return
            try:
                self._migrate_one(key)
            except Exception:  # noqa: BLE001 — a torn migration drops
                # one cache entry; the worker itself must survive
                logger.warning(
                    "kv tier migration failed; entry dropped",
                    exc_info=True,
                )
                with self._lock:
                    self._staging.pop(key, None)
                    self.dropped += 1
            finally:
                with self._idle:
                    self._inflight -= 1
                    self._idle.notify_all()

    def _migrate_one(self, key: bytes) -> None:
        with self._lock:
            staged = self._staging.get(key)
            already_host = key in self._host
        if staged is None:
            return  # raced with discard()
        raw, pin = staged
        if not already_host:
            # async prefix-page demotion: quantize + insert
            if faults.ACTIVE is not None:
                faults.inject("kvtier.demote")
            payload = quantize_payload(raw)
            with self._lock:
                if self._closed:
                    return
                self._staging.pop(key, None)
                self._insert_host(key, _Entry(payload, pin))
            self._count("demote")
            return
        # spill: host copy stays authoritative until the rename lands
        payload = quantize_payload(raw)
        if self.disk_dir is not None and self._disk_write(key, payload):
            with self._lock:
                ent = self._host.pop(key, None)
                if ent is not None:
                    self._host_used -= ent.n_pages
                self._staging.pop(key, None)
                self._set_gauges()
        else:
            with self._lock:
                self._staging.pop(key, None)

    # -- disk tier (jobstore partial-store idiom) -----------------------

    def _disk_path(self, key: bytes) -> Path:
        return self.disk_dir / (
            hashlib.blake2b(key, digest_size=16).hexdigest() + ".npz"
        )

    def _scan_disk(self) -> None:
        for p in self.disk_dir.glob("*.npz"):
            try:
                with np.load(p) as z:
                    self._disk[bytes(z["key"].tobytes())] = int(
                        z["k"].shape[1]
                    )
            except Exception:  # noqa: BLE001 — torn leftovers quarantine
                self._quarantine(p)

    def _disk_write(
        self, key: bytes, payload: Dict[str, np.ndarray]
    ) -> bool:
        path = self._disk_path(key)
        tmp = path.with_suffix(".npz.tmp")
        try:
            if faults.ACTIVE is not None:
                spec = faults.fire("kvtier.disk_write")
                if spec is not None:
                    if spec.kind == "torn":
                        # crash between write and fsync on a non-durable
                        # fs: a truncated bundle at the FINAL name (the
                        # reader quarantines it; the host copy stays)
                        import io

                        buf = io.BytesIO()
                        np.savez(
                            buf, key=np.frombuffer(key, np.uint8),
                            **payload,
                        )
                        data = buf.getvalue()
                        path.write_bytes(data[: max(8, len(data) // 2)])
                    spec.trigger()
            with open(tmp, "wb") as f:
                np.savez(f, key=np.frombuffer(key, np.uint8), **payload)
            tmp.replace(path)  # atomic on POSIX
        except Exception:  # noqa: BLE001 — durability is best-effort;
            # the host copy stays authoritative
            logger.warning("kv tier disk write failed", exc_info=True)
            try:
                tmp.unlink(missing_ok=True)
            except OSError:
                pass
            return False
        with self._lock:
            self._disk[key] = int(payload["k"].shape[1])
            self._set_gauges()
        self._count("disk_write")
        return True

    def _disk_read(
        self, key: bytes
    ) -> Optional[Dict[str, np.ndarray]]:
        path = self._disk_path(key)
        try:
            with np.load(path) as z:
                if bytes(z["key"].tobytes()) != key:
                    raise ValueError("key mismatch (hash collision?)")
                payload = {
                    k: np.array(z[k])
                    for k in _PAYLOAD_KEYS
                    if k in z.files
                }
        except FileNotFoundError:
            with self._lock:
                self._disk.pop(key, None)
            return None
        except Exception as e:  # noqa: BLE001 — torn bundle: quarantine
            logger.warning(
                "quarantining corrupt kv tier bundle %s: %s", path, e
            )
            self._quarantine(path)
            with self._lock:
                self._disk.pop(key, None)
                self._set_gauges()
            return None
        self._count("disk_read")
        return payload

    def _quarantine(self, path: Path) -> None:
        try:
            cdir = path.parent / ".corrupt"
            cdir.mkdir(exist_ok=True)
            path.replace(cdir / path.name)
        except OSError:
            try:
                path.unlink(missing_ok=True)
            except OSError:
                pass
