"""Token-level FSM over the schema NFA + vocabulary masks.

The per-sequence object the scheduler drives (scheduler.TokenConstraint
protocol): ``allowed_tokens()`` yields a [V] bool mask for the sampling op
(ops/sampling.py), ``advance(token)`` consumes the sampled token's bytes.

Performance model (SURVEY §7.3 "vectorized constrained decoding"): masks
are cached per NFA state-set in a job-wide ``MaskCache`` shared by every
row, so the steady-state cost per decode step is one dict lookup — string
content, for instance, is a single self-looping state. Computing a mask
for a *new* state simulates every vocab token's bytes; the optional C++
core (native/fsm.cpp, loaded via ctypes in cpp.py) accelerates exactly
that inner loop, with this pure-Python path as the always-available
fallback.
"""

from __future__ import annotations

import logging
from typing import Dict, FrozenSet, List, Optional

import numpy as np

from .nfa import NFA

logger = logging.getLogger(__name__)


class TokenTable:
    """Per-tokenizer byte strings for every vocab id, plus stop ids."""

    def __init__(self, tokenizer) -> None:
        V = tokenizer.vocab_size
        self.vocab_size = V
        self.token_bytes: List[bytes] = [
            tokenizer.token_bytes(i) for i in range(V)
        ]
        stop = getattr(tokenizer, "stop_ids", None)
        self.stop_ids: List[int] = list(stop()) if stop else [tokenizer.eos_id]
        # ids that contribute no bytes (specials) — never valid inside JSON,
        # only as terminators
        self.empty_ids = np.array(
            [i for i, b in enumerate(self.token_bytes) if not b], np.int64
        )
        self._b2t: Optional[Dict[bytes, List[int]]] = None
        self._max_tok_len = 0

    def matches_longest_first(self, data: bytes, start: int):
        """Yield (token id, byte length) vocab matches at
        ``data[start:]``, longest first. Built lazily (one dict over
        the vocab). ALL ids sharing a byte string are yielded — a
        consumer filtering by an FSM mask may admit only a duplicate
        id, and yielding just the first-listed one would truncate its
        fast-forward plan early."""
        if self._b2t is None:
            b2t: Dict[bytes, List[int]] = {}
            for tid, tb in enumerate(self.token_bytes):
                if tb:
                    b2t.setdefault(tb, []).append(tid)
            self._b2t = b2t
            self._max_tok_len = max(
                (len(b) for b in b2t), default=0
            )
        for ln in range(
            min(self._max_tok_len, len(data) - start), 0, -1
        ):
            tids = self._b2t.get(data[start : start + ln])
            if tids is not None:
                for tid in tids:
                    yield tid, ln


INF_DIST = np.int32(0x7FFFFFFF)


class MaskCache:
    """state-set -> (vocab mask, per-token post-walk byte distance to
    accept), shared across all rows of a job. The distance array is what
    makes budget-aware decoding O(V) per step: the scheduler ANDs the
    cached mask with ``dist_after <= remaining - 1`` instead of ever
    re-walking tokens."""

    def __init__(self, nfa: NFA, table: TokenTable):
        self.nfa = nfa
        self.table = table
        self._cache: Dict[
            FrozenSet[int], "tuple[np.ndarray, np.ndarray]"
        ] = {}
        self._cpp = None
        try:
            from .cpp import CppMasker

            self._cpp = CppMasker(nfa, table)
        except (ImportError, OSError) as e:
            # expected on hosts without the built native extension —
            # the pure-Python walk is the always-available fallback
            logger.debug("CppMasker unavailable (%s); pure-python mask walk", e)
        except Exception:
            # anything else is a real bug worth surfacing, but masking
            # must keep working: classify loudly, fall back anyway
            logger.exception(
                "CppMasker init failed; falling back to pure-python mask walk"
            )

    @property
    def core(self) -> str:
        """The core that computes new masks: ``"native"`` (native/fsm.cpp)
        or ``"python"`` (the fallback walk, when the toolchain is absent)."""
        return "python" if self._cpp is None else "native"

    def mask(self, states: FrozenSet[int]) -> np.ndarray:
        return self.mask_and_dist(states)[0]

    def mask_and_dist(
        self, states: FrozenSet[int]
    ) -> "tuple[np.ndarray, np.ndarray]":
        cached = self._cache.get(states)
        if cached is not None:
            return cached
        if self._cpp is not None:
            m, dist = self._cpp.mask(states)
        else:
            m, dist = self._compute(states)
        # terminal: allow stop tokens so the model can end cleanly
        # (distance 0 — emitting stop costs no further closing bytes)
        if self.nfa.is_accepting(states):
            for sid in self.table.stop_ids:
                m[sid] = True
                dist[sid] = 0
        self._cache[states] = (m, dist)
        return m, dist

    def _compute(
        self, states: FrozenSet[int]
    ) -> "tuple[np.ndarray, np.ndarray]":
        nfa = self.nfa
        m = np.zeros(self.table.vocab_size, bool)
        dist = np.full(self.table.vocab_size, INF_DIST, np.int32)
        byte_ok = nfa.allowed_bytes(states)
        for tid, tb in enumerate(self.table.token_bytes):
            if not tb or not byte_ok[tb[0]]:
                continue
            cur = states
            ok = True
            for b in tb:
                cur = nfa.step(cur, b)
                if not cur:
                    ok = False
                    break
            m[tid] = ok
            if ok:
                d = nfa.dist_to_accept(cur)
                dist[tid] = np.int32(d) if np.isfinite(d) else INF_DIST
        return m, dist


class TokenFSM:
    """One row's constraint state (scheduler.TokenConstraint)."""

    def __init__(self, nfa: NFA, masks: MaskCache, table: TokenTable):
        self.nfa = nfa
        self.masks = masks
        self.table = table
        self.states = nfa.initial()
        self._complete = False

    def token_allowed(
        self, token_id: int, remaining: Optional[int] = None
    ) -> bool:
        """O(1) single-token validity check (speculative-decode
        verification: the scheduler samples fused windows unmasked for
        greedy rows and accepts the longest FSM-valid prefix). In the
        budget-infeasible corner this returns False where
        ``allowed_tokens`` would degrade to the unfiltered mask — the
        scheduler's follow-up masked step applies the exact degrade
        semantics, so behavior converges."""
        token_id = int(token_id)
        if self._complete:
            return token_id in self.table.stop_ids
        m, dist = self.masks.mask_and_dist(self.states)
        if token_id >= m.shape[0] or not m[token_id]:
            return False
        if remaining is not None and dist[token_id] > max(
            int(remaining) - 1, 0
        ):
            return False
        return True

    def min_tokens(self) -> int:
        """Shortest possible accepting output in tokens (upper-bounded by
        bytes: every kept token advances >= 1 byte). The engine raises a
        row's generation cap to at least this, so a small user
        ``max_new_tokens`` cannot make the schema guarantee infeasible."""
        d = self.nfa.dist_to_accept(self.nfa.initial())
        return int(d) if np.isfinite(d) else 0

    def allowed_tokens(self, remaining: Optional[int] = None) -> np.ndarray:
        """Vocab mask; with ``remaining`` (token budget left for this row)
        tokens whose post-walk shortest path to accept no longer fits the
        budget are filtered out EVERY step. Invariant: if the budget covers
        the distance at step 0, it covers it at every step (each kept
        token satisfies dist_after <= remaining-1, and the next mask always
        contains the shortest path's single-byte tokens) — so schema rows
        always finish with complete JSON instead of a mid-string cut."""
        if self._complete:
            m = np.zeros(self.table.vocab_size, bool)
            for sid in self.table.stop_ids:
                m[sid] = True
            return m
        m, dist = self.masks.mask_and_dist(self.states)
        if remaining is not None:
            fits = m & (dist <= max(int(remaining) - 1, 0))
            if fits.any():
                return fits
            # budget was infeasible from the start (or non-byte stop path):
            # degrade to the unfiltered mask rather than dead-ending
        return m

    def plan_fastforward(
        self,
        remaining: Optional[int],
        max_tokens: int,
        max_cand: int,
    ):
        """Plan a masked-verify jump (scheduler FSM fast-forward): walk
        the FORCED byte path from the current state (exactly one
        allowed byte per step, stopping at accepting states), tokenize
        it greedy-longest, and collect the (small) budget-filtered
        candidate mask at every token boundary — candidates are what
        the device argmaxes over, so each planned position yields the
        EXACT masked-path token. Under byte-level tokenization the
        candidate sets are singletons; under BPE vocabs they are the
        path's prefix tokenizations (plus boundary crossers), still
        small. The final position is the first free choice point,
        included while its mask also fits ``max_cand`` (enum leaves).

        Returns ``(draft_ids, cand_sets)`` with ``len(cand_sets) in
        (len(draft_ids), len(draft_ids) + 1)``, or ``None`` when
        nothing is plannable. NEVER mutates FSM state (the NFA walk is
        purely functional) — accepting planned tokens later advances
        the FSM through the normal paths."""
        if self._complete:
            return None
        nfa = self.nfa
        # forced byte path
        forced = bytearray()
        cur = self.states
        cap_bytes = 8 * max_tokens
        while len(forced) < cap_bytes and not nfa.is_accepting(cur):
            bo = np.flatnonzero(nfa.allowed_bytes(cur))
            if len(bo) != 1:
                break
            forced.append(int(bo[0]))
            cur = nfa.step(cur, int(bo[0]))
        forced = bytes(forced)

        draft: List[int] = []
        cands: List[np.ndarray] = []
        cur = self.states
        i = 0
        while len(draft) < max_tokens:
            m, dist = self.masks.mask_and_dist(cur)
            if remaining is not None:
                rem_j = remaining - len(draft)
                fits = m & (dist <= max(int(rem_j) - 1, 0))
                mm = fits if fits.any() else m  # allowed_tokens degrade
            else:
                mm = m
            cand = np.flatnonzero(mm)
            if len(cand) == 0 or len(cand) > max_cand:
                break
            cands.append(cand.astype(np.int32))
            if i >= len(forced):
                break  # final free choice point planned; stop here
            # draft continuation: longest vocab match along the forced
            # path that the (filtered) mask admits
            tid, ln = -1, 0
            for t, L in self.table.matches_longest_first(forced, i):
                if mm[t]:
                    tid, ln = t, L
                    break
            if ln <= 0:
                break  # boundary stays as this plan's final position
            draft.append(int(tid))
            for b in forced[i : i + ln]:
                cur = nfa.step(cur, b)
            i += ln
        if not cands:
            return None
        return draft, cands

    def advance(self, token_id: int) -> None:
        if self._complete:
            return
        tb = self.table.token_bytes[int(token_id)]
        if not tb:
            # special token (stop) — only legal at accept; mark complete
            self._complete = self.nfa.is_accepting(self.states)
            return
        cur = self.states
        for b in tb:
            cur = self.nfa.step(cur, b)
            if not cur:
                # mask guarantees this can't happen; fail safe by completing
                self._complete = True
                return
        self.states = cur
        if self.nfa.is_accepting(cur) and not np.any(
            self.nfa.allowed_bytes(cur)
        ):
            # accepting with no outgoing bytes => JSON fully emitted
            self._complete = True

    def is_complete(self) -> bool:
        return self._complete


class ConstraintFactory:
    def __init__(self, schema: Dict, tokenizer):
        from .schema import compile_schema

        self.nfa = compile_schema(schema)
        self.table = TokenTable(tokenizer)
        self.masks = MaskCache(self.nfa, self.table)

    def __call__(self) -> TokenFSM:
        return TokenFSM(self.nfa, self.masks, self.table)


def schema_constraint_factory(schema: Dict, tokenizer) -> ConstraintFactory:
    return ConstraintFactory(schema, tokenizer)


# constraint type names whose missing-min_tokens warning already fired
_room_warned: set = set()


def constraint_room(constraint) -> int:
    """Minimum generation room (tokens) a row needs to honor its
    constraint: the shortest accepting output plus one stop token.

    Single source of truth for BOTH the job-creation max_new_tokens bump
    (api.py) and the scheduler's truncation reserve — the two must agree
    or admission and truncation drift apart. Constraints are duck-typed;
    one that cannot report a minimum falls back to 1 WITH a logged
    warning (a silent fallback would reintroduce the invalid-JSON
    truncation bug this exists to prevent)."""
    mt = getattr(constraint, "min_tokens", None)
    if not callable(mt):
        # warn once per constraint TYPE, not per row — constraint_room
        # sits in the per-row admission loop and a 10k-row job would
        # otherwise emit 10k identical lines
        t = type(constraint)
        if t not in _room_warned:
            _room_warned.add(t)
            import logging

            logging.getLogger(__name__).warning(
                "constraint %r has no callable min_tokens(); assuming 1 "
                "token of room (schema-completeness no longer guaranteed "
                "for its rows)",
                t.__name__,
            )
        return 1
    try:
        return max(1, int(mt()) + 1)
    except Exception:
        import logging

        logging.getLogger(__name__).warning(
            "constraint min_tokens() failed; assuming 1 token of room "
            "(schema-completeness no longer guaranteed for this row)",
            exc_info=True,
        )
        return 1
