"""Byte-level NFA combinators (Thompson construction).

Foundation of schema-constrained decoding (SURVEY §2.3: "JSON-schema →
token-level FSM compiler + per-step logit mask"). The schema compiler
(schema.py) lowers a JSON schema to a regex-like combinator tree; this
module builds an epsilon-NFA over *bytes* from it. Byte-level (not
char-level) so multi-byte UTF-8 inside tokens works unmodified with
byte-level BPE vocabularies.

Transitions carry 256-entry numpy bool bitmaps, so simulating a token's
byte string is a few dict/set hops per byte, and the token-mask builder
(fsm.py) can vectorize over the vocabulary.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Tuple

import numpy as np


def bitmap(*byte_ranges: Tuple[int, int]) -> np.ndarray:
    m = np.zeros(256, bool)
    for lo, hi in byte_ranges:
        m[lo : hi + 1] = True
    return m


def bitmap_of(chars: bytes) -> np.ndarray:
    m = np.zeros(256, bool)
    for b in chars:
        m[b] = True
    return m


ANY_BYTE = bitmap((0, 255))


@dataclasses.dataclass
class NFA:
    """start/accept plus transition tables; built by the combinators below."""

    n_states: int
    start: int
    accept: int
    # state -> list of (bitmap over bytes, next_state)
    edges: Dict[int, List[Tuple[np.ndarray, int]]]
    eps: Dict[int, List[int]]

    def eps_closure(self, states: FrozenSet[int]) -> FrozenSet[int]:
        out = set(states)
        stack = list(states)
        while stack:
            s = stack.pop()
            for t in self.eps.get(s, ()):
                if t not in out:
                    out.add(t)
                    stack.append(t)
        return frozenset(out)

    def step(self, states: FrozenSet[int], byte: int) -> FrozenSet[int]:
        nxt = set()
        for s in states:
            for bm, t in self.edges.get(s, ()):
                if bm[byte]:
                    nxt.add(t)
        if not nxt:
            return frozenset()
        return self.eps_closure(frozenset(nxt))

    def initial(self) -> FrozenSet[int]:
        return self.eps_closure(frozenset([self.start]))

    def is_accepting(self, states: FrozenSet[int]) -> bool:
        return self.accept in states

    def is_dead(self, states: FrozenSet[int]) -> bool:
        return len(states) == 0

    def allowed_bytes(self, states: FrozenSet[int]) -> np.ndarray:
        m = np.zeros(256, bool)
        for s in states:
            for bm, _ in self.edges.get(s, ()):
                m |= bm
        return m

    def byte_distances(self) -> np.ndarray:
        """Per-state minimum bytes to reach accept (inf if unreachable).

        0-1 BFS over the reversed graph (byte edges cost 1, epsilon cost
        0). Powers budget-aware forced closure: when a row's remaining
        token budget approaches this distance, the mask is narrowed to
        distance-decreasing bytes so constrained rows always emit complete
        JSON (the reference's "guaranteed JSON" contract even at the
        length cap)."""
        cached = getattr(self, "_byte_dist", None)
        if cached is not None:
            return cached
        from collections import deque

        INF = np.inf
        rev_byte: Dict[int, List[int]] = {}
        rev_eps: Dict[int, List[int]] = {}
        for s, lst in self.edges.items():
            for _, t in lst:
                rev_byte.setdefault(t, []).append(s)
        for s, lst in self.eps.items():
            for t in lst:
                rev_eps.setdefault(t, []).append(s)
        dist = np.full(self.n_states, INF)
        dist[self.accept] = 0.0
        dq = deque([self.accept])
        while dq:
            u = dq.popleft()
            d = dist[u]
            for v in rev_eps.get(u, ()):      # eps edge v->u: cost 0
                if d < dist[v]:
                    dist[v] = d
                    dq.appendleft(v)
            for v in rev_byte.get(u, ()):     # byte edge v->u: cost 1
                if d + 1 < dist[v]:
                    dist[v] = d + 1
                    dq.append(v)
        self._byte_dist = dist
        return dist

    def dist_to_accept(self, states: FrozenSet[int]) -> float:
        if not states:
            return np.inf
        d = self.byte_distances()
        return min(d[s] for s in states)


class Builder:
    """Mutable builder; combinator methods return (start, accept) fragments."""

    def __init__(self) -> None:
        self.n = 0
        self.edges: Dict[int, List[Tuple[np.ndarray, int]]] = {}
        self.eps: Dict[int, List[int]] = {}

    def state(self) -> int:
        s = self.n
        self.n += 1
        return s

    def edge(self, a: int, bm: np.ndarray, b: int) -> None:
        self.edges.setdefault(a, []).append((bm, b))

    def epsilon(self, a: int, b: int) -> None:
        self.eps.setdefault(a, []).append(b)

    # -- combinators ----------------------------------------------------
    def lit(self, data: bytes) -> Tuple[int, int]:
        start = self.state()
        cur = start
        for b in data:
            nxt = self.state()
            self.edge(cur, bitmap_of(bytes([b])), nxt)
            cur = nxt
        return start, cur

    def char(self, bm: np.ndarray) -> Tuple[int, int]:
        a, b = self.state(), self.state()
        self.edge(a, bm, b)
        return a, b

    def seq(self, *frags: Tuple[int, int]) -> Tuple[int, int]:
        if not frags:
            s = self.state()
            return s, s
        for (s1, a1), (s2, _) in zip(frags, frags[1:]):
            self.epsilon(a1, s2)
        return frags[0][0], frags[-1][1]

    def alt(self, *frags: Tuple[int, int]) -> Tuple[int, int]:
        start, accept = self.state(), self.state()
        for s, a in frags:
            self.epsilon(start, s)
            self.epsilon(a, accept)
        return start, accept

    def star(self, frag: Tuple[int, int]) -> Tuple[int, int]:
        start, accept = self.state(), self.state()
        s, a = frag
        self.epsilon(start, s)
        self.epsilon(start, accept)
        self.epsilon(a, s)
        self.epsilon(a, accept)
        return start, accept

    def plus(self, frag: Tuple[int, int]) -> Tuple[int, int]:
        s, a = frag
        start, accept = self.state(), self.state()
        self.epsilon(start, s)
        self.epsilon(a, accept)
        self.epsilon(a, s)
        return start, accept

    def opt(self, frag: Tuple[int, int]) -> Tuple[int, int]:
        s, a = frag
        start, accept = self.state(), self.state()
        self.epsilon(start, s)
        self.epsilon(start, accept)
        self.epsilon(a, accept)
        return start, accept

    def build(self, frag: Tuple[int, int]) -> NFA:
        return NFA(
            n_states=self.n,
            start=frag[0],
            accept=frag[1],
            edges=self.edges,
            eps=self.eps,
        )
