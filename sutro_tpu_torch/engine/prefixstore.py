"""Engine-lifetime radix prefix store over the paged KV pool.

The port of ``sutro_tpu/engine/prefixstore.py`` (numpy only).

Cross-JOB KV reuse (RadixAttention / SGLang is the prior-art shape):
the per-job
``_SharedPrefix`` in engine/scheduler.py prefills a template shell once
per job — but the reference's bread-and-butter workloads send the SAME
shell for millions of rows across many jobs, co-batched jobs, resumed
jobs, and every ``/v1/chat/completions`` call with a repeated system
prompt. This store keeps those prefilled pages alive across batcher
sessions so the second job (or request) prefills only its novel tail.

Shape: a radix tree keyed on PAGE-ALIGNED token runs — every node owns
exactly one KV page (``page_size`` tokens), children keyed by the raw
bytes of the next page's token run. Page granularity makes the tree a
true radix structure over the only boundaries the paged pool can share
at, and keeps splitting/merging trivial (an edge is always one page).
A node's KV content is only valid joined with its ancestors (causal
attention: page *i*'s keys attend over tokens ``0..i*PS``), so lookups
pin whole root paths and eviction removes leaves only.

Ownership protocol (the part that must be exact):

- The store's pages live in the RUNNER's KV pool, which outlives any
  ``ContinuousBatcher``. Each new batcher builds a fresh allocator over
  that pool, so its constructor calls :meth:`owned_pages` and reserves
  them (``PageAllocator.reserve`` / native ``rt_reserve_pages``) before
  any admission — store pages are never in a session's free list.
- ``lookup_pin`` pins the matched path (refcount per node); pinned
  nodes NEVER evict. ``extend`` transfers ownership of freshly
  prefilled tail pages into the tree (pinned by the same handle).
  ``release`` unpins; the pages STAY in the store (and out of the
  allocator) for the next job — this is the whole point.
- Under allocation pressure the scheduler calls :meth:`evict`, which
  removes unpinned leaves in LRU order and returns their page ids for
  the CALLER to hand back to its live allocator (the store itself
  never touches an allocator: allocators are session-scoped, the store
  is engine-scoped).
- ``close`` drops the tree (engine shutdown / runner-cache eviction).
  Orphaned device pages need no cleanup — the pool dies with the
  runner — but a subsequently constructed batcher reserves nothing, so
  its ``free_count`` returns to the pristine pool size.

Kill switch: the store only exists when ``EngineConfig.prefix_store``
is on and ``SUTRO_PREFIX_STORE`` is not ``0``/``off`` — the scheduler
holds ``None`` otherwise and runs today's per-job path bit-identically.
Fault site ``prefixstore.lookup`` (engine/faults.py) degrades any store
crash during lookup to a plain miss; a job never fails because the
cache did.

Determinism: LRU stamps come from a logical clock (no wall time), and
reusing a stored page is bit-identical to re-prefilling it — KV values
depend only on (tokens, positions), never on page ids or on which job
wrote them.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np

from .. import telemetry


class PrefixHandle:
    """A pinned root path: ``nodes`` root→deep, ``pages`` their page
    ids in table order, ``tokens`` the covered (page-aligned) token
    count. Returned by ``lookup_pin`` (possibly empty = miss) and
    extended in place by ``extend``; balance every handle with exactly
    one ``release``."""

    __slots__ = ("nodes", "pages", "tokens")

    def __init__(self, nodes: List["_Node"], page_size: int):
        self.nodes = nodes
        self.pages = [n.page for n in nodes]
        self.tokens = len(nodes) * page_size


class _Node:
    __slots__ = ("key", "page", "parent", "children", "refs", "stamp")

    def __init__(self, key: bytes, page: int, parent: Optional["_Node"]):
        self.key = key
        self.page = page
        self.parent = parent
        self.children: Dict[bytes, "_Node"] = {}
        self.refs = 0
        self.stamp = 0


class PrefixStore:
    def __init__(self, page_size: int):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.page_size = int(page_size)
        self._children: Dict[bytes, _Node] = {}  # root's children
        self._lock = threading.RLock()
        self._clock = 0  # logical LRU clock (no wall time: determinism)
        self._n_pages = 0
        self._closed = False
        # exact counters, mirrored into the telemetry registry
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.tokens_saved = 0
        # tiered variants (engine/kvtier.py): leaves demoted to the
        # host tier instead of dropped, and pages re-grafted on a tier
        # hit. Disjoint from evictions/extends so the migration loop
        # is visible in stats even when the tier nets out to zero.
        self.demotions = 0
        self.promotions = 0

    # -- internals ------------------------------------------------------

    def _chunks(self, tokens: np.ndarray):
        """Page-run keys for ``tokens`` (truncated to page alignment)."""
        arr = np.ascontiguousarray(np.asarray(tokens, np.int32))
        PS = self.page_size
        for i in range(len(arr) // PS):
            yield arr[i * PS : (i + 1) * PS].tobytes()

    def _touch(self, node: _Node) -> None:
        self._clock += 1
        node.stamp = self._clock

    # -- lookup / extend / release --------------------------------------

    def lookup_pin(self, tokens: np.ndarray) -> PrefixHandle:
        """Longest page-aligned match for ``tokens``; the matched path
        is pinned (refcount +1 per node) until ``release``. An empty
        handle (``tokens == 0``) is a miss and needs no release (but
        tolerates one)."""
        with self._lock:
            nodes: List[_Node] = []
            if not self._closed:
                children = self._children
                for key in self._chunks(tokens):
                    node = children.get(key)
                    if node is None:
                        break
                    nodes.append(node)
                    children = node.children
                for n in nodes:
                    n.refs += 1
                    self._touch(n)
            h = PrefixHandle(nodes, self.page_size)
            if nodes:
                self.hits += 1
                self.tokens_saved += h.tokens
                if telemetry.ENABLED:
                    telemetry.PREFIX_STORE_HITS_TOTAL.inc(1.0)
                    telemetry.PREFIX_STORE_TOKENS_SAVED_TOTAL.inc(
                        float(h.tokens)
                    )
            else:
                self.misses += 1
                if telemetry.ENABLED:
                    telemetry.PREFIX_STORE_MISSES_TOTAL.inc(1.0)
            return h

    def extend(
        self, handle: PrefixHandle, tail_tokens: np.ndarray,
        pages: List[int],
    ) -> bool:
        """Graft freshly prefilled tail pages under ``handle``'s deepest
        node, transferring page ownership to the store and pinning the
        new nodes on the same handle. ``tail_tokens`` must cover
        ``len(pages)`` whole pages. Returns False without taking
        ownership when the store is closed (caller keeps freeing the
        pages per job, exactly the storeless path) or when a concurrent
        insert already landed the same run (ours would be a duplicate —
        caller keeps its pages)."""
        keys = list(self._chunks(tail_tokens))
        if len(keys) != len(pages):
            raise ValueError(
                f"tail covers {len(keys)} pages, got {len(pages)} ids"
            )
        with self._lock:
            if self._closed:
                return False
            parent = handle.nodes[-1] if handle.nodes else None
            children = parent.children if parent else self._children
            if keys and keys[0] in children:
                return False  # racer inserted the same run first
            for key, page in zip(keys, pages):
                node = _Node(key, int(page), parent)
                node.refs = 1  # pinned by this handle
                self._touch(node)
                children[key] = node
                self._n_pages += 1
                handle.nodes.append(node)
                handle.pages.append(int(page))
                parent, children = node, node.children
            handle.tokens = len(handle.nodes) * self.page_size
            return True

    def empty_handle(self) -> PrefixHandle:
        """A zero-length handle to ``extend`` from the root (cold-store
        insert). No pins, no hit/miss accounting."""
        return PrefixHandle([], self.page_size)

    def release(self, handle: PrefixHandle) -> None:
        with self._lock:
            for n in handle.nodes:
                if n.refs > 0:
                    n.refs -= 1
            handle.nodes = []

    def peek(self, tokens: np.ndarray) -> int:
        """Non-mutating warm-token probe (serving gateway TTFT
        attribution): how many leading tokens of ``tokens`` are already
        resident. No pinning, no LRU touch, no hit/miss accounting."""
        with self._lock:
            if self._closed:
                return 0
            hit = 0
            children = self._children
            for key in self._chunks(tokens):
                node = children.get(key)
                if node is None:
                    break
                hit += self.page_size
                children = node.children
            return hit

    # -- eviction / lifecycle -------------------------------------------

    def evict(self, n_pages: int) -> List[int]:
        """Remove up to ``n_pages`` pages from UNPINNED leaves in LRU
        order (evicting a leaf may expose its parent as the next
        candidate) and return their page ids — the caller returns them
        to its live allocator. Pinned nodes, and interior nodes above
        them, are never touched."""
        freed: List[int] = []
        with self._lock:
            while len(freed) < n_pages:
                victim: Optional[_Node] = None
                stack = list(self._children.values())
                while stack:
                    node = stack.pop()
                    if node.children:
                        stack.extend(node.children.values())
                    elif node.refs == 0 and (
                        victim is None or node.stamp < victim.stamp
                    ):
                        victim = node
                if victim is None:
                    break
                parent = victim.parent
                siblings = (
                    parent.children if parent else self._children
                )
                del siblings[victim.key]
                self._n_pages -= 1
                freed.append(victim.page)
                self.evictions += 1
            if freed and telemetry.ENABLED:
                telemetry.PREFIX_STORE_EVICTIONS_TOTAL.inc(
                    float(len(freed))
                )
        return freed

    def demote(self, n_pages: int) -> List[tuple]:
        """Tiered eviction (engine/kvtier.py): remove up to ``n_pages``
        UNPINNED LRU leaves exactly like :meth:`evict`, but return
        ``(path_bytes, page_id)`` pairs, where ``path_bytes`` is the
        raw int32 bytes of the FULL token prefix through that page
        (root path keys concatenated) — the content key the tier pool
        stores the page payload under. A node's KV is only valid joined
        with its ancestors, so the key must cover the whole path, never
        the leaf's single-page run. The caller reads the page payloads
        out of the runner BEFORE handing the ids back to its allocator."""
        out: List[tuple] = []
        with self._lock:
            while len(out) < n_pages:
                victim: Optional[_Node] = None
                stack = list(self._children.values())
                while stack:
                    node = stack.pop()
                    if node.children:
                        stack.extend(node.children.values())
                    elif node.refs == 0 and (
                        victim is None or node.stamp < victim.stamp
                    ):
                        victim = node
                if victim is None:
                    break
                path: List[bytes] = []
                n: Optional[_Node] = victim
                while n is not None:
                    path.append(n.key)
                    n = n.parent
                path.reverse()
                parent = victim.parent
                siblings = (
                    parent.children if parent else self._children
                )
                del siblings[victim.key]
                self._n_pages -= 1
                out.append((b"".join(path), victim.page))
                self.demotions += 1
            if out and telemetry.ENABLED:
                telemetry.PREFIX_STORE_EVICTIONS_TOTAL.inc(
                    float(len(out))
                )
        return out

    def promote(
        self, handle: PrefixHandle, tail_tokens: np.ndarray,
        pages: List[int],
    ) -> bool:
        """Re-graft pages whose payloads were just uploaded from a
        lower tier (scheduler ``_promote_prefix``) under ``handle`` —
        the exact :meth:`extend` ownership transfer, counted
        separately so the tier round-trip is visible next to plain
        extends. Returns False (caller keeps the pages) when the store
        is closed or a racer re-inserted the run first."""
        ok = self.extend(handle, tail_tokens, pages)
        if ok:
            with self._lock:
                self.promotions += len(pages)
        return ok

    def owned_pages(self) -> List[int]:
        """Every page id the tree owns (batcher constructors reserve
        these out of their fresh free lists)."""
        with self._lock:
            out: List[int] = []
            stack = list(self._children.values())
            while stack:
                node = stack.pop()
                out.append(node.page)
                stack.extend(node.children.values())
            return out

    @property
    def n_pages(self) -> int:
        with self._lock:
            return self._n_pages

    def reset(self) -> None:
        """Forget every node WITHOUT returning pages anywhere — for a
        batcher whose fresh allocator could not re-reserve the store's
        pages (pool geometry changed): the ids are already free there,
        so dropping the tree is the only consistent move."""
        with self._lock:
            self._children = {}
            self._n_pages = 0

    def close(self) -> None:
        """Engine shutdown / runner-cache eviction: drop the tree and
        refuse future extends (lookups miss). The device pool dies with
        the runner; the next batcher over a surviving pool reserves
        nothing, so its free count returns to the pristine pool size."""
        with self._lock:
            self._closed = True
            self._children = {}
            self._n_pages = 0
