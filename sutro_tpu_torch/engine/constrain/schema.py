"""JSON schema -> byte NFA compiler.

Port of ``sutro_tpu/engine/constrain/schema.py`` (unchanged). Lowers
the ``output_schema`` contract of the reference SDK (sutro/sdk.py:
451,490-493 — Pydantic model or JSON-schema dict, normalized to a dict
before it gets here) into a byte-level NFA accepting exactly the
canonical JSON serializations that validate.

Canonicalization choices (standard for constrained decoding): object keys
are emitted in schema ``properties`` order; no insignificant whitespace.
Optional (non-required) properties are genuinely optional branches in the
automaton. Supported schema features: object/properties/required (incl.
nested), string (enum/const, minLength/maxLength, ``pattern`` via the
regex subset in constrain/regex.py — unsupported constructs fall back to
type-valid-unchecked with a warning; well-known ``format`` grammars
enforced), integer (exact minimum/maximum/exclusive bounds via a
digit-interval automaton; ``multipleOf`` 1..512 composed exactly via a
remainder-tracking product automaton), number (exact minimum/maximum
incl. STRICT real bounds via a decimal interval automaton — bounded
numbers emit in plain positional form, no exponent), boolean, null,
array (items, minItems/maxItems small; ``uniqueItems`` enforced for
enum pools of <=5 distinct values), anyOf/oneOf, $ref/$defs (incl.
RECURSIVE models: unrolled to MAX_REF_DEPTH, then recursion-reaching
branches are pruned subset-safely — Optional arms keep null, arrays
close to []; structurally-required recursion hard-fails with a clear
message instead of a RecursionError), multi-element ``allOf``
(intersection-merged over the supported feature set; inexpressible
intersections hard-fail rather than silently widen), and
``additionalProperties`` (declared-property objects never emit extras,
so ``false`` closure holds by construction; property-less objects with
a value schema compile to a free-form map).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

from .nfa import NFA, Builder, bitmap, bitmap_of

Frag = Tuple[int, int]

# JSON string content: ASCII except '"' (0x22), '\' (0x5C), and control
# bytes < 0x20; non-ASCII must form exact UTF-8 sequences (modeled below —
# a loose 0x80-0xFF class would let the FSM emit invalid UTF-8 under
# forced closure or adversarial sampling). Escapes: \ + "\/bfnrt or uXXXX.
_STR_PLAIN = bitmap((0x20, 0x21), (0x23, 0x5B), (0x5D, 0x7F))
_CONT = (0x80, 0xBF)  # UTF-8 continuation byte
_ESC_SIMPLE = bitmap_of(b'"\\/bfnrt')
_HEX = bitmap((0x30, 0x39), (0x41, 0x46), (0x61, 0x66))
_DIGIT = bitmap((0x30, 0x39))
_DIGIT19 = bitmap((0x31, 0x39))


# canonical textual grammars for the common string formats (enforced —
# see the format branch in compile_node). RFC-shaped, not exhaustive
# calendars: 2026-02-31 passes (per-month day counts would explode the
# automaton for negligible gain).
_DATE = r"\d{4}-(0[1-9]|1[0-2])-(0[1-9]|[12][0-9]|3[01])"
_TIME = (
    r"([01][0-9]|2[0-3]):[0-5][0-9]:[0-5][0-9]"
    r"(\.[0-9]{1,9})?(Z|[+-]([01][0-9]|2[0-3]):[0-5][0-9])?"
)
_IPV4_OCTET = r"(25[0-5]|2[0-4][0-9]|1[0-9][0-9]|[1-9]?[0-9])"
_FORMAT_PATTERNS = {
    "uuid": (
        r"^[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-"
        r"[0-9a-f]{4}-[0-9a-f]{12}$"
    ),
    "date": f"^{_DATE}$",
    "time": f"^{_TIME}$",
    "date-time": f"^{_DATE}T{_TIME}$",
    "email": r"^[A-Za-z0-9._%+-]{1,64}@[A-Za-z0-9.-]{1,63}\.[A-Za-z]{2,24}$",
    "ipv4": f"^({_IPV4_OCTET}\\.){{3}}{_IPV4_OCTET}$",
}


def _canon(x: Any) -> str:
    """Canonical JSON text for value identity — distinguishes True from
    1 (Python ``==`` does not) and ignores dict key order."""
    return json.dumps(x, separators=(",", ":"), sort_keys=True)


def _same(a: Any, b: Any) -> bool:
    try:
        return _canon(a) == _canon(b)
    except (TypeError, ValueError):
        return a is b


def _integral(mod) -> Optional[int]:
    """Positive-int view of a multipleOf value (2 or 2.0 -> 2), None if
    it isn't integral — mirrors compile_node's normalization so merge
    filtering and compilation agree."""
    if isinstance(mod, bool) or mod is None:
        return None
    if isinstance(mod, int):
        return mod
    if isinstance(mod, float) and mod.is_integer():
        return int(mod)
    return None


def _dec_digits(value) -> Tuple[str, str]:
    """Decimal -> (integer-digit string, fraction-digit string), both
    without signs; e.g. 12.305 -> ("12", "305"), 7 -> ("7", "")."""
    import decimal

    # copy_abs also strips the sign of negative zero (-0.0 compares == 0,
    # so `if d < 0: d = -d` would leak the '-' into the digit string)
    d = decimal.Decimal(value).copy_abs()
    s = format(d, "f")
    if "." in s:
        i, f = s.split(".", 1)
    else:
        i, f = s, ""
    return (i.lstrip("0") or "0"), f


def _pattern_proves_bounds(
    pattern: str, node: Dict[str, Any]
) -> Optional[bool]:
    """Does ``pattern``'s language provably satisfy ``node``'s
    minLength/maxLength? Tristate shared by the allOf merge and
    compile_node so the proving predicate cannot drift between them:
    True = provably satisfied (bounds are redundant), False = pattern is
    supported but the bounds are NOT provably satisfied (compile_node
    would enforce the pattern and drop the bounds), None = pattern is
    outside the regex subset (compile_node's fallback enforces the
    BOUNDS and warns the pattern is unenforced — no widening)."""
    from .regex import UnsupportedPattern, pattern_length_bounds

    try:
        plo, phi = pattern_length_bounds(pattern)
    except UnsupportedPattern:
        return None
    return plo >= int(node.get("minLength", 0)) and (
        "maxLength" not in node
        or (phi is not None and phi <= int(node["maxLength"]))
    )


class SchemaCompiler:
    # recursive $refs (self-referential Pydantic models) unroll to this
    # depth, then recursion-reaching branches are PRUNED (subset-safe:
    # Optional[Node] keeps its null arm, List[Node] closes to []);
    # required unprunable recursion hard-fails with a clear message
    # instead of a RecursionError
    MAX_REF_DEPTH = 3

    def __init__(self, schema: Dict[str, Any]):
        self.b = Builder()
        self.defs: Dict[str, Any] = {}
        for key in ("$defs", "definitions"):
            self.defs.update(schema.get(key, {}))
        self.schema = schema
        self._ref_stack: List[str] = []
        self._merge_depth = 0

    # -- JSON primitives -------------------------------------------------
    def _string_char(self) -> Frag:
        b = self.b
        esc = b.seq(
            b.char(bitmap_of(b"\\")),
            b.alt(
                b.char(_ESC_SIMPLE),
                b.seq(
                    b.char(bitmap_of(b"u")),
                    b.char(_HEX), b.char(_HEX), b.char(_HEX), b.char(_HEX),
                ),
            ),
        )
        # exact UTF-8 multibyte sequences (RFC 3629 table: no overlongs,
        # no surrogates, max U+10FFFF)
        utf8 = b.alt(
            b.seq(b.char(bitmap((0xC2, 0xDF))), b.char(bitmap(_CONT))),
            b.seq(
                b.char(bitmap((0xE0, 0xE0))),
                b.char(bitmap((0xA0, 0xBF))), b.char(bitmap(_CONT)),
            ),
            b.seq(
                b.char(bitmap((0xE1, 0xEC), (0xEE, 0xEF))),
                b.char(bitmap(_CONT)), b.char(bitmap(_CONT)),
            ),
            b.seq(
                b.char(bitmap((0xED, 0xED))),
                b.char(bitmap((0x80, 0x9F))), b.char(bitmap(_CONT)),
            ),
            b.seq(
                b.char(bitmap((0xF0, 0xF0))),
                b.char(bitmap((0x90, 0xBF))),
                b.char(bitmap(_CONT)), b.char(bitmap(_CONT)),
            ),
            b.seq(
                b.char(bitmap((0xF1, 0xF3))),
                b.char(bitmap(_CONT)), b.char(bitmap(_CONT)),
                b.char(bitmap(_CONT)),
            ),
            b.seq(
                b.char(bitmap((0xF4, 0xF4))),
                b.char(bitmap((0x80, 0x8F))),
                b.char(bitmap(_CONT)), b.char(bitmap(_CONT)),
            ),
        )
        return b.alt(b.char(_STR_PLAIN), esc, utf8)

    def _string_frag(
        self, min_len: int = 0, max_len: Optional[int] = None
    ) -> Frag:
        b = self.b
        if max_len is None:
            content = b.star(self._string_char())
            if min_len:
                required = [self._string_char() for _ in range(min_len)]
                content = b.seq(*required, content)
            return b.seq(b.lit(b'"'), content, b.lit(b'"'))
        # bounded: minLength required chars then up to (max-min) optional.
        # NOTE: counts *escaped chars*, a close proxy for codepoints.
        parts: List[Frag] = [self._string_char() for _ in range(min_len)]
        opt_tail = None
        for _ in range(max(max_len - min_len, 0)):
            piece = self._string_char()
            opt_tail = (
                b.opt(piece)
                if opt_tail is None
                else b.opt(b.seq(piece, opt_tail))
            )
        frags = [b.lit(b'"'), *parts]
        if opt_tail is not None:
            frags.append(opt_tail)
        frags.append(b.lit(b'"'))
        return b.seq(*frags)

    def _integer_frag(self) -> Frag:
        b = self.b
        body = b.alt(
            b.lit(b"0"),
            b.seq(b.char(_DIGIT19), b.star(b.char(_DIGIT))),
        )
        return b.seq(b.opt(b.lit(b"-")), body)

    def _digits_interval(
        self, a: str, c: str, mod: Optional[int] = None
    ) -> Optional[Frag]:
        """Digit strings d with ``a <= d <= c`` (equal lengths, no
        leading-zero concerns — callers arrange that). Classic
        tight-prefix construction: state = (position, still tight to the
        low bound, still tight to the high bound); memoized so the
        fragment graph is O(len * 10). With ``mod`` the walk also
        tracks the running remainder (product automaton) and only
        strings whose VALUE is divisible by ``mod`` are accepted —
        exact multipleOf composed with the interval. Returns None when
        the language is empty (no multiple in range)."""
        b = self.b
        memo: Dict[Tuple[int, bool, bool, int], Optional[Frag]] = {}

        def rec(i: int, tl: bool, th: bool, r: int) -> Optional[Frag]:
            if i == len(a):
                if mod is not None and r != 0:
                    return None
                return b.seq()  # epsilon
            key = (i, tl, th, r)
            if key in memo:
                return memo[key]
            lo_d = int(a[i]) if tl else 0
            hi_d = int(c[i]) if th else 9
            alts = []
            for d in range(lo_d, hi_d + 1):
                nr = (r * 10 + d) % mod if mod is not None else 0
                nxt = rec(i + 1, tl and d == lo_d, th and d == hi_d, nr)
                if nxt is not None:
                    alts.append(b.seq(b.lit(str(d).encode()), nxt))
            frag = b.alt(*alts) if alts else None
            memo[key] = frag
            return frag

        return rec(0, True, True, 0)

    def _nonneg_interval(
        self, lo: int, hi: int, mod: Optional[int] = None
    ) -> Optional[Frag]:
        """Decimal representations (no leading zeros) of [lo, hi],
        lo >= 0, optionally restricted to multiples of ``mod``."""
        b = self.b
        alts: List[Frag] = []
        a0, c0 = str(lo), str(hi)
        for L in range(len(a0), len(c0) + 1):
            a_l = a0 if L == len(a0) else "1" + "0" * (L - 1)
            c_l = c0 if L == len(c0) else "9" * L
            if int(a_l) > int(c_l):
                continue
            frag = self._digits_interval(a_l, c_l, mod)
            if frag is not None:
                alts.append(frag)
        if not alts:
            return None
        return b.alt(*alts) if len(alts) > 1 else alts[0]

    def _bounded_int_frag(
        self,
        lo: Optional[int],
        hi: Optional[int],
        mod: Optional[int] = None,
    ) -> Frag:
        """Integers restricted by JSON-schema minimum/maximum and
        (optionally) ``multipleOf``.

        Exact in every case: two-sided bounds use the interval automaton
        over digit positions on each sign's magnitude — with ``mod``
        the same walk carries the running remainder (product automaton),
        so e.g. minimum 3 / maximum 100 / multipleOf 7 admits exactly
        7, 14, ..., 98. One-sided bounds bound one sign's magnitude and
        leave the other open (k | v <=> k | |v|, so the mod walk applies
        per magnitude)."""
        b = self.b

        # lazy: Builder fragments allocate states immediately, so only
        # the branch taken should construct its pieces
        def nonneg() -> Frag:
            if mod is not None:
                return self._mod_dfa(mod, include_zero=True)
            return b.alt(
                b.lit(b"0"),
                b.seq(b.char(_DIGIT19), b.star(b.char(_DIGIT))),
            )

        def positive() -> Frag:
            if mod is not None:
                return self._mod_dfa(mod, include_zero=False)
            return b.seq(b.char(_DIGIT19), b.star(b.char(_DIGIT)))

        def guard(f: Optional[Frag]) -> Frag:
            if f is None:
                raise ValueError(
                    f"no multiple of {mod} in integer range [{lo}, {hi}]"
                )
            return f

        if lo is not None and hi is not None:
            if lo > hi:
                raise ValueError(f"integer minimum {lo} > maximum {hi}")
            alts = []
            if hi < 0:
                return b.seq(
                    b.lit(b"-"),
                    guard(self._nonneg_interval(-hi, -lo, mod)),
                )
            if lo < 0:
                neg = self._nonneg_interval(1, -lo, mod)
                if neg is not None:
                    alts.append(b.seq(b.lit(b"-"), neg))
                lo = 0
            pos = self._nonneg_interval(lo, hi, mod)
            if pos is not None:
                alts.append(pos)
            if not alts:
                raise ValueError(
                    f"no multiple of {mod} in integer range [{lo}, {hi}]"
                )
            return b.alt(*alts) if len(alts) > 1 else alts[0]
        if lo is not None:  # [lo, inf)
            if lo > 0:
                return self._unbounded_above(lo, mod)
            if lo == 0:
                return nonneg()
            # negatives down to lo, all non-negatives
            alts = [nonneg()]
            neg = self._nonneg_interval(1, -lo, mod)
            if neg is not None:
                alts.append(b.seq(b.lit(b"-"), neg))
            return b.alt(*alts) if len(alts) > 1 else alts[0]
        if hi is not None:  # (-inf, hi]
            if hi < 0:
                return b.seq(b.lit(b"-"), self._unbounded_above(-hi, mod))
            # all negatives, non-negatives up to hi
            alts = [b.seq(b.lit(b"-"), positive())]
            pos = self._nonneg_interval(0, hi, mod)
            if pos is not None:
                alts.append(pos)
            return b.alt(*alts) if len(alts) > 1 else alts[0]
        if mod is not None:
            return b.seq(b.opt(b.lit(b"-")), nonneg())
        return self._integer_frag()

    def _mod_core(self, k: int) -> Tuple[List[int], int]:
        """Remainder-state machine shared by the divisibility paths:
        k states with digit edges r -> (10r+d) % k, plus the accept
        state reachable (epsilon) from remainder 0. O(k * 10) edges."""
        b = self.b
        states = [b.state() for _ in range(k)]
        accept = b.state()
        for r in range(k):
            for d in range(10):
                b.edge(
                    states[r],
                    bitmap_of(str(d).encode()),
                    states[(r * 10 + d) % k],
                )
        b.epsilon(states[0], accept)
        return states, accept

    def _mod_dfa(self, k: int, include_zero: bool) -> Frag:
        """Non-negative decimal strings (no leading zeros) whose value
        is divisible by ``k``."""
        b = self.b
        states, accept = self._mod_core(k)
        start = b.state()
        for d in range(1, 10):
            b.edge(start, bitmap_of(str(d).encode()), states[d % k])
        if include_zero:
            z = b.state()
            b.edge(start, bitmap_of(b"0"), z)
            b.epsilon(z, accept)
        return start, accept

    def _unbounded_above(self, lo: int, mod: Optional[int] = None) -> Frag:
        """Exact [lo, inf) for lo >= 1 (optionally multiples of
        ``mod``): magnitudes of the same digit count bounded below by
        the interval automaton, any longer digit string free — with
        ``mod`` the longer branch threads its running remainder through
        the same-length walk into a remainder DFA tail."""
        b = self.b
        a0 = str(lo)
        alts: List[Frag] = []
        same = self._digits_interval(a0, "9" * len(a0), mod)
        if same is not None:
            alts.append(same)
        if mod is None:
            longer = b.seq(
                b.char(_DIGIT19),
                *[b.char(_DIGIT) for _ in range(len(a0))],
                b.star(b.char(_DIGIT)),
            )
            alts.append(longer)
        else:
            # longer strings: walk len(a0)+1 leading digits tracking the
            # remainder, then land in the mod-DFA's remainder states
            states, accept = self._mod_core(mod)
            # feeders: (len(a0)+1)-digit prefixes ending at remainder r
            # can stop (accept iff r == 0) or continue in the DFA
            feed: Dict[int, int] = {}

            def feeder(i: int, r: int) -> int:
                key = i * mod + r
                got = feed.get(key)
                if got is not None:
                    return got
                s = b.state()
                if i == len(a0) + 1:
                    b.epsilon(s, states[r])
                else:
                    first = i == 0
                    for d in range(0 if not first else 1, 10):
                        b.edge(
                            s,
                            bitmap_of(str(d).encode()),
                            feeder(i + 1, (r * 10 + d) % mod),
                        )
                feed[key] = s
                return s

            alts.append((feeder(0, 0), accept))
        # alts is never empty: the longer/feeder branch is unconditional
        # (multiples of mod >= lo always exist)
        assert alts
        return b.alt(*alts) if len(alts) > 1 else alts[0]

    def _number_frag(self) -> Frag:
        b = self.b
        frac = b.seq(b.lit(b"."), b.plus(b.char(_DIGIT)))
        exp = b.seq(
            b.char(bitmap_of(b"eE")),
            b.opt(b.char(bitmap_of(b"+-"))),
            b.plus(b.char(_DIGIT)),
        )
        return b.seq(self._integer_frag(), b.opt(frac), b.opt(exp))

    # -- bounded decimals --------------------------------------------------
    def _exp_safe_range(
        self, mag_lo, strict_lo: bool, mag_hi
    ) -> Optional[Tuple[Optional[int], Optional[int]]]:
        """Exponents E for which EVERY canonical-scientific mantissa
        (one nonzero integer digit, so m in [1, 10)) keeps ``m * 10**E``
        inside the magnitude interval — the "safe box" that lets
        bounded numbers use exponent form without per-mantissa bound
        tracking. Returns (e_min, e_max), either side None = unbounded;
        None = no safe exponent exists. Magnitudes are positive
        ``decimal.Decimal`` (or None for an open side)."""
        e_max: Optional[int] = None
        if mag_hi is not None:
            # sup m*10**E = 10**(E+1), not attained: safe iff
            # 10**(E+1) <= mag_hi (strictness-safe for open bounds too)
            e_max = mag_hi.adjusted() - 1
        e_min: Optional[int] = None
        if mag_lo is not None and mag_lo > 0:
            import decimal

            j = mag_lo.adjusted()
            # min m*10**E = 10**E (attained at m=1): needs
            # 10**E >= mag_lo, strict when the bound is open
            exact_pow = mag_lo == decimal.Decimal(10) ** j
            e_min = j if (exact_pow and not strict_lo) else j + 1
        if e_min is not None and e_max is not None and e_min > e_max:
            return None
        return e_min, e_max

    def _exp_frag(self, e_min: Optional[int], e_max: Optional[int]) -> Frag:
        """``e<int>`` exponent tail for the safe box: canonical
        scientific mantissa ([1-9], optional fraction) is supplied by
        the caller; this emits ``e`` + an integer in [e_min, e_max]
        (either side open), reusing the exact bounded-integer walk."""
        b = self.b
        if e_min is None and e_max is None:
            body = self._integer_frag()
        else:
            body = self._bounded_int_frag(e_min, e_max)
        return b.seq(b.lit(b"e"), body)

    def _bounded_number_frag(
        self, lo, hi, open_lo: bool = False, open_hi: bool = False
    ) -> Frag:
        """Decimals in the interval between ``lo`` and ``hi``
        (``decimal.Decimal`` or None for an open side; ``open_*`` make
        the bound strict). Exact including strict real bounds: the
        tight digit walk simply never accepts the boundary string
        itself. The negative side mirrors via reversed magnitudes.

        Positional form covers the ENTIRE interval. Exponent form is
        additionally admitted inside the "safe box" (_exp_safe_range):
        canonical scientific strings whose value is guaranteed in-range
        for any mantissa, so astronomically wide bounds (e.g.
        ``maximum: 1e308``) don't force a 300-digit positional emission
        — boundary-adjacent decades stay positional-only (subset
        discipline; VERDICT r3 missing #7)."""
        import decimal

        b = self.b
        ZERO = decimal.Decimal(0)
        alts: List[Frag] = []
        mant = lambda: b.seq(  # noqa: E731 — local shorthand
            b.char(_DIGIT19),
            b.opt(b.seq(b.lit(b"."), b.plus(b.char(_DIGIT)))),
        )
        # exponent-form branches (value magnitude m * 10**E, m in [1,10))
        if hi is None or hi > 0:  # positive side exists
            rng = self._exp_safe_range(
                lo if (lo is not None and lo > 0) else None,
                open_lo,
                hi,
            )
            if rng is not None:
                alts.append(b.seq(mant(), self._exp_frag(*rng)))
        if lo is None or lo < 0:  # negative side exists
            rng = self._exp_safe_range(
                -hi if (hi is not None and hi < 0) else None,
                open_hi,
                None if lo is None else -lo,
            )
            if rng is not None:
                alts.append(
                    b.seq(b.lit(b"-"), mant(), self._exp_frag(*rng))
                )
        # negative side: value v = -m; v >= lo <=> m <= -lo (open flips
        # to the magnitude's high side), v <= hi<=0 <=> m >= -hi
        if lo is None or lo < 0:
            if hi is not None and hi <= 0:
                m_lo, m_open_lo = -hi, open_hi
            else:
                m_lo, m_open_lo = None, False
            m_hi = None if lo is None else -lo
            neg = self._nonneg_decimal(
                m_lo, m_hi, open_lo=m_open_lo, open_hi=open_lo
            )
            if neg is not None:
                alts.append(b.seq(b.lit(b"-"), neg))
        # non-negative side (absent when hi < 0, or hi == 0 strict)
        if hi is None or hi > 0 or (hi == 0 and not open_hi):
            if lo is not None and lo >= 0:
                nn_lo, nn_open = lo, open_lo
            else:
                nn_lo, nn_open = ZERO, False
            nn = self._nonneg_decimal(
                nn_lo, hi, open_lo=nn_open, open_hi=open_hi
            )
            if nn is not None:
                alts.append(nn)
        if not alts:
            raise ValueError(f"empty number interval [{lo}, {hi}]")
        return b.alt(*alts) if len(alts) > 1 else alts[0]

    def _nonneg_decimal(
        self, lo, hi, open_lo: bool = False, open_hi: bool = False
    ) -> Optional[Frag]:
        """Decimals d >= 0 between lo and hi (None = open side). Split
        by integer-digit count so leading zeros never arise; only the
        spans touching a bound walk tight. None = empty language."""
        import decimal

        b = self.b
        if lo is None or lo < 0:
            lo, open_lo = decimal.Decimal(0), False
        if hi is not None and (lo > hi or (lo == hi and (open_lo or open_hi))):
            return None
        ilo_len = max(len(str(int(lo))), 1)
        alts: List[Frag] = []
        if hi is None:
            span = self._decimal_span(lo, None, ilo_len, open_lo, False)
            if span is not None:
                alts.append(span)
            # any number with more integer digits clears lo
            alts.append(
                b.seq(
                    b.char(_DIGIT19),
                    *[b.char(_DIGIT) for _ in range(ilo_len)],
                    b.star(b.char(_DIGIT)),
                    b.opt(b.seq(b.lit(b"."), b.plus(b.char(_DIGIT)))),
                )
            )
        else:
            ihi_len = max(len(str(int(hi))), 1)
            if ilo_len == ihi_len:
                span = self._decimal_span(
                    lo, hi, ilo_len, open_lo, open_hi
                )
                if span is not None:
                    alts.append(span)
            else:
                # tight-low span at lo's width, tight-high span at hi's
                # width, and ONE compact fragment for every interior
                # integer-digit length — O(width) total, not a per-
                # length span loop (quadratic for astronomically wide
                # bounds like le=1.8e308)
                span = self._decimal_span(
                    lo, None, ilo_len, open_lo, False
                )
                if span is not None:
                    alts.append(span)
                if ihi_len - ilo_len >= 2:
                    mlo, mhi = ilo_len + 1, ihi_len - 1
                    tail = None
                    for _ in range(mhi - mlo):
                        piece = b.char(_DIGIT)
                        tail = b.opt(
                            piece if tail is None else b.seq(piece, tail)
                        )
                    parts: List[Frag] = [b.char(_DIGIT19)]
                    parts += [b.char(_DIGIT) for _ in range(mlo - 1)]
                    if tail is not None:
                        parts.append(tail)
                    parts.append(
                        b.opt(b.seq(b.lit(b"."), b.plus(b.char(_DIGIT))))
                    )
                    alts.append(b.seq(*parts))
                span = self._decimal_span(
                    decimal.Decimal(10 ** (ihi_len - 1)), hi, ihi_len,
                    False, open_hi,
                )
                if span is not None:
                    alts.append(span)
        if not alts:
            return None
        return b.alt(*alts) if len(alts) > 1 else alts[0]

    def _decimal_span(
        self, lo, hi, width: int, open_lo: bool, open_hi: bool
    ) -> Optional[Frag]:
        """Decimals whose integer part has exactly ``width`` digits
        (width 1 admits 0), between lo and hi. ``hi`` None = free high
        side WITHIN this width (caller caps the span). Returns None for
        an empty language (e.g. lo == hi with a strict bound)."""
        b = self.b
        ilo, flo = _dec_digits(lo)
        ilo = ilo.rjust(width, "0")
        flo = flo.rstrip("0")
        if hi is not None:
            ihi, fhi = _dec_digits(hi)
            ihi = ihi.rjust(width, "0")
            fhi = fhi.rstrip("0")
        else:
            ihi, fhi = "", ""
        memo: Dict[Tuple[str, int, bool, bool, bool], Optional[Frag]] = {}

        def frac(j: int, tl: bool, th: bool, first: bool) -> Optional[Frag]:
            # tight-low normalization: once lo's remaining fraction
            # digits are all zeros (flo is stripped, so that means
            # exhausted), a CLOSED low bound is vacuously satisfied; a
            # STRICT one persists (the value must still exceed lo)
            if tl and j >= len(flo) and not open_lo:
                tl = False
            if not tl and not th:
                d = b.char(_DIGIT)
                return b.plus(d) if first else b.star(d)
            exhausted_lo = tl and j >= len(flo)   # strict-low equality path
            exhausted_hi = th and j >= len(fhi)
            if exhausted_lo and exhausted_hi:
                # prefix equals BOTH bounds' extensions: only zeros can
                # follow, value stays == lo (== hi); a strict bound on
                # either side makes this path dead
                return None if (open_lo or open_hi) else (
                    b.plus(b.char(bitmap_of(b"0"))) if first
                    else b.star(b.char(bitmap_of(b"0")))
                )
            if exhausted_lo and not th:
                # strict low, equality so far: zeros then a nonzero
                # digit, then free
                return b.seq(
                    b.star(b.char(bitmap_of(b"0"))),
                    b.char(_DIGIT19),
                    b.star(b.char(_DIGIT)),
                )
            if exhausted_hi and not tl:
                # equality-with-hi path: zeros keep it equal — dead when
                # strict, zeros-only when closed
                if open_hi:
                    return None
                z = b.char(bitmap_of(b"0"))
                return b.plus(z) if first else b.star(z)
            key = ("f", j, tl, th, first)
            if key in memo:
                return memo[key]
            lo_d = int(flo[j]) if (tl and j < len(flo)) else 0
            hi_d = int(fhi[j]) if (th and j < len(fhi)) else (0 if th else 9)
            alts = []
            for d in range(lo_d, hi_d + 1):
                rest = frac(
                    j + 1, tl and d == lo_d, th and d == hi_d, False
                )
                if rest is not None:
                    alts.append(b.seq(b.lit(str(d).encode()), rest))
            # stop: value becomes prefix+zeros. While tl (closed, digits
            # remain) that undershoots lo; under strict-low equality it
            # EQUALS lo — both forbidden, so `not tl` covers it. On the
            # high side j < len(fhi) here, so prefix+zeros < hi strictly.
            if not first and not tl:
                alts.append(b.seq())
            f = b.alt(*alts) if alts else None
            memo[key] = f
            return f

        def intpart(i: int, tl: bool, th: bool) -> Optional[Frag]:
            if i == width:
                dot_body = frac(0, tl, th, True)
                dot = (
                    None if dot_body is None
                    else b.seq(b.lit(b"."), dot_body)
                )
                # stopping here = integer value (no fraction): equals lo
                # exactly iff tl and flo empty; equals hi iff th and fhi
                # empty (strict bounds forbid those)
                stop_ok = not (tl and (len(flo) > 0 or open_lo))
                if stop_ok and th and len(fhi) == 0 and open_hi:
                    stop_ok = False
                if dot is None and not stop_ok:
                    return None
                if not stop_ok:
                    return dot
                if dot is None:
                    return b.seq()
                return b.opt(dot)
            key = ("i", i, tl, th, False)
            if key in memo:
                return memo[key]
            lo_d = int(ilo[i]) if tl else 0
            hi_d = int(ihi[i]) if th else 9
            if i == 0 and width > 1 and not tl:
                lo_d = max(lo_d, 1)  # no leading zeros
            alts = []
            for d in range(lo_d, hi_d + 1):
                rest = intpart(i + 1, tl and d == lo_d, th and d == hi_d)
                if rest is not None:
                    alts.append(b.seq(b.lit(str(d).encode()), rest))
            f = b.alt(*alts) if alts else None
            memo[key] = f
            return f

        return intpart(0, True, hi is not None)

    def _pattern_frag(self, pattern: str) -> Optional[Frag]:
        """Compile a string ``pattern`` (constrain/regex.py). Returns
        None — unconstrained-string fallback — for constructs the regex
        subset cannot express; the fallback is the pre-pattern behavior
        (type-valid but pattern-unchecked), kept so exotic patterns
        don't fail whole jobs. minLength/maxLength are not intersected
        with a compiled pattern (NFA intersection is out of scope);
        the pattern wins."""
        import warnings

        from .regex import UnsupportedPattern, compile_pattern

        b = self.b
        try:
            body = compile_pattern(b, pattern, self._string_char)
        except UnsupportedPattern as e:
            warnings.warn(
                f"output_schema pattern {pattern!r} not enforced: {e}",
                stacklevel=2,
            )
            return None
        return b.seq(b.lit(b'"'), body, b.lit(b'"'))

    # -- schema nodes ------------------------------------------------------
    def _resolve(self, schema: Dict[str, Any]) -> Dict[str, Any]:
        # iterative ref-chain follow with a cycle guard: a def that IS
        # a $ref back into the chain (alias cycle A -> B -> A) must be
        # a clear error, not a RecursionError
        seen: set = set()
        while "$ref" in schema:
            name = schema["$ref"].split("/")[-1]
            if name in seen:
                raise ValueError(
                    f"recursive $ref alias cycle through {name!r}"
                )
            seen.add(name)
            if name not in self.defs:
                raise ValueError(f"Unresolvable $ref: {schema['$ref']}")
            schema = self.defs[name]
        if "allOf" in schema:
            merged = self._merge_allof(schema)
            return self._resolve(merged) if "$ref" in merged else merged
        return schema

    # annotation-only keys: no validation semantics, last writer wins
    _ANNOTATIONS = frozenset(
        (
            "title", "description", "default", "examples", "deprecated",
            "readOnly", "writeOnly", "$schema", "$id", "$comment",
            "discriminator",
        )
    )

    def _merge_allof(self, schema: Dict[str, Any]) -> Dict[str, Any]:
        """Intersection-merge an ``allOf`` (any number of branches, plus
        sibling keys) into one equivalent schema over the compiler's
        supported feature set.

        Subset discipline (module docstring) forbids silently dropping a
        conjunct — emitting a superset of the user's language breaks the
        schema guarantee — so intersections this compiler cannot express
        (two distinct ``pattern``s, ``oneOf`` conjuncts, mixed draft-4
        boolean exclusive bounds, ...) raise ``ValueError`` with a clear
        message instead. ``anyOf`` conjuncts distribute exactly:
        allOf(anyOf(A,B), C) == anyOf(allOf(A,C), allOf(B,C))."""
        # recursion guard: refs expanded inline here (and by _resolve)
        # never pass through compile_node's MAX_REF_DEPTH counter, so a
        # def cycle that lives entirely at allOf/anyOf level would
        # otherwise recurse this method to a RecursionError. Real
        # schemas nest allOf a handful deep; 32 is far above any
        # legitimate structure.
        self._merge_depth += 1
        try:
            if self._merge_depth > 32:
                raise ValueError(
                    "allOf: recursive $ref expansion exceeds the merge "
                    "depth limit (def cycle through allOf/anyOf?)"
                )
            return self._merge_allof_impl(schema)
        finally:
            self._merge_depth -= 1

    def _merge_allof_impl(self, schema: Dict[str, Any]) -> Dict[str, Any]:
        from itertools import product as _product

        parts = [dict(self._resolve(s)) for s in schema["allOf"]]
        siblings = {k: v for k, v in schema.items() if k != "allOf"}
        if siblings:
            parts.append(dict(self._resolve(siblings)))

        def constrains(p: Dict[str, Any]) -> bool:
            return any(k not in self._ANNOTATIONS for k in p)

        # distribute anyOf conjuncts (exact); oneOf's exactly-one
        # semantics are NOT preserved by distribution — hard fail
        choices: List[List[Dict[str, Any]]] = []
        for p in parts:
            if "oneOf" in p:
                extra = [
                    k
                    for k in p
                    if k != "oneOf" and k not in self._ANNOTATIONS
                ]
                others = [
                    q for q in parts if q is not p and constrains(q)
                ]
                if extra or others:
                    # distributing oneOf loses its exactly-one semantics
                    # (a value matching two branches would be emitted) —
                    # only a lone oneOf conjunct (modulo annotations)
                    # passes through untouched
                    raise ValueError(
                        "allOf: a oneOf conjunct cannot be intersected "
                        "exactly with other constraints"
                    )
            choices.append(self._expand_anyof(p))
        n_combos = 1
        for c in choices:
            n_combos *= len(c)
        if n_combos > 64:
            raise ValueError(
                f"allOf: anyOf distribution needs {n_combos} branches "
                "(max 64)"
            )
        if n_combos > 1:
            # merge each distributed branch eagerly so an unsatisfiable
            # or inexpressible one is PRUNED (anyOf needs only one
            # branch to hold; dropping a branch narrows, never widens) —
            # raising only when every branch dies
            branches: List[Dict[str, Any]] = []
            errs: List[str] = []
            for combo in _product(*choices):
                try:
                    branches.append(
                        self._merge_allof({"allOf": list(combo)})
                    )
                except ValueError as e:
                    errs.append(str(e))
            if not branches:
                raise ValueError(
                    "allOf: every distributed anyOf branch is "
                    "unsatisfiable: " + "; ".join(errs[:3])
                )
            if errs:
                import warnings

                warnings.warn(
                    f"allOf: pruned {len(errs)} unsatisfiable anyOf "
                    f"branch(es) (first: {errs[0]})",
                    stacklevel=2,
                )
            return {"anyOf": branches}

        out: Dict[str, Any] = {}
        # (declared-property keyset, additionalProperties) per object
        # part — needed after the union to honor each conjunct's own
        # closure, which applies relative to ITS properties, not the
        # merged set
        part_objs: List[Tuple[set, Any]] = []
        for p in (dict(self._resolve(c[0])) for c in choices):
            # the compiler's object default is all-properties-required
            # (_object_frag); make it explicit BEFORE the union so a
            # part with implicit required doesn't lose it to a sibling
            # part's explicit (smaller) required list. Runs here, after
            # anyOf expansion, so expanded branches are covered too.
            if "properties" in p and "required" not in p:
                p["required"] = list(p["properties"])
            # normalize draft-4 boolean exclusive bounds to the numeric
            # draft-2020 form per part, BEFORE the union — a boolean
            # flag surviving the merge would re-attach to a bound
            # tightened by a different conjunct and change semantics
            for bkey, xkey in (
                ("minimum", "exclusiveMinimum"),
                ("maximum", "exclusiveMaximum"),
            ):
                flag = p.get(xkey)
                if isinstance(flag, bool):
                    if flag and bkey in p:
                        p[xkey] = p.pop(bkey)
                    else:
                        p.pop(xkey)
            if "properties" in p or "additionalProperties" in p:
                part_objs.append(
                    (
                        set(p.get("properties", {})),
                        p.get("additionalProperties"),
                    )
                )
            for k, v in p.items():
                if k in ("$defs", "definitions"):
                    continue  # hoisted into self.defs at construction
                if k not in out:
                    out[k] = v
                    continue
                out[k] = self._merge_key(k, out[k], v)
        # each conjunct's additionalProperties closure applies to the
        # properties IT declared: under `false`, merged extras must not
        # be emitted (required extra -> unsatisfiable, optional extra ->
        # dropped, which narrows); under a schema, merged extras must
        # also satisfy the conjunct's value schema
        props = out.get("properties")
        if props and not set(out.get("required", [])) <= set(props):
            # _object_frag can only emit declared properties — a
            # required name with no schema would make every output fail
            # the user's own validation
            missing = sorted(set(out["required"]) - set(props))
            raise ValueError(
                f"allOf: required properties {missing} have no schema "
                "in any conjunct"
            )
        if props and part_objs:
            # copy before mutating — a single-part merge aliases the
            # caller's schema dict
            out["properties"] = props = dict(props)
            required = set(out.get("required", []))
            for keys, addl in part_objs:
                if addl is False:
                    extras = set(props) - keys
                    bad = extras & required
                    if bad:
                        raise ValueError(
                            "allOf: required properties "
                            f"{sorted(bad)} violate a conjunct's "
                            "additionalProperties: false"
                        )
                    for name in extras:
                        del props[name]
                elif isinstance(addl, dict):
                    for name in set(props) - keys:
                        props[name] = {"allOf": [props[name], addl]}
        # compile_node prefers pattern over minLength/maxLength, so a
        # SUPPORTED pattern arriving from one conjunct would silently
        # drop length bounds arriving from another — the same
        # silent-widening the two-pattern case hard-fails on. Bounds the
        # pattern provably satisfies are dropped as redundant; a
        # supported-but-unprovable combination hard-fails (NFA∩length
        # intersection is out of scope). An UNSUPPORTED pattern keeps
        # both keys: compile_node's fallback enforces the bounds and
        # warns the pattern is unenforced — no widening either way. A
        # merged enum/const skips all of this: compile_node prefers it,
        # and the filtering below checks members against pattern AND
        # bounds exactly.
        if (
            "pattern" in out
            and ("minLength" in out or "maxLength" in out)
            and "enum" not in out
            and "const" not in out
        ):
            proof = _pattern_proves_bounds(out["pattern"], out)
            if proof is True:
                out.pop("minLength", None)
                out.pop("maxLength", None)
            elif proof is False:
                raise ValueError(
                    "allOf: pattern cannot be proven to satisfy "
                    "minLength/maxLength conjuncts "
                    f"({out['pattern']!r} vs "
                    f"[{out.get('minLength', 0)}, "
                    f"{out.get('maxLength', 'inf')}])"
                )
        # compile_node prefers enum/const over sibling keywords, so a
        # merged enum/const must be filtered against every conjunct
        # constraint here or the merge silently widens (e.g.
        # allOf([{enum:[1,20]}, {minimum:10}]) must not emit 1)
        if "enum" in out:
            vals = [
                v for v in out["enum"] if self._value_satisfies(v, out)
            ]
            if not vals:
                raise ValueError(
                    "allOf: enum empty after applying conjunct "
                    "constraints"
                )
            out["enum"] = vals
        if "const" in out and not self._value_satisfies(
            out["const"], out
        ):
            raise ValueError(
                "allOf: const value violates conjunct constraints"
            )
        if "const" in out and "enum" in out:
            # const must be a member, and then it subsumes the enum
            if _canon(out["const"]) not in {
                _canon(x) for x in out["enum"]
            }:
                raise ValueError(
                    "allOf: const value not in intersected enum"
                )
            del out["enum"]
        return out

    def _value_satisfies(self, v: Any, out: Dict[str, Any]) -> bool:
        """Check one enum/const value against the scalar constraints of
        a merged schema (type, numeric bounds, multipleOf, string
        length, pattern). Used only by the allOf merge — a single
        schema's enum-beats-siblings precedence is compile_node's
        long-standing behavior."""

        if "enum" in out and _canon(v) not in {
            _canon(x) for x in out["enum"]
        }:
            return False
        if "const" in out and _canon(v) != _canon(out["const"]):
            return False
        if "anyOf" in out and not any(
            self._value_satisfies(v, self._resolve(br))
            for br in out["anyOf"]
        ):
            return False
        if "oneOf" in out and sum(
            self._value_satisfies(v, self._resolve(br))
            for br in out["oneOf"]
        ) != 1:
            return False
        t = out.get("type")
        if t is not None:
            types = t if isinstance(t, list) else [t]

            def type_ok(tt: str) -> bool:
                if tt == "string":
                    return isinstance(v, str)
                if tt == "boolean":
                    return isinstance(v, bool)
                if tt == "null":
                    return v is None
                if tt == "integer":
                    return (
                        isinstance(v, int) and not isinstance(v, bool)
                    ) or (isinstance(v, float) and v.is_integer())
                if tt == "number":
                    return isinstance(v, (int, float)) and not isinstance(
                        v, bool
                    )
                if tt == "array":
                    return isinstance(v, list)
                if tt == "object":
                    return isinstance(v, dict)
                return True

            if not any(type_ok(tt) for tt in types):
                return False
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            import decimal

            d = decimal.Decimal(str(v))
            lo, open_lo, hi, open_hi = _number_bounds(out)
            if lo is not None and (d < lo or (open_lo and d == lo)):
                return False
            if hi is not None and (d > hi or (open_hi and d == hi)):
                return False
            mod = out.get("multipleOf")
            if not isinstance(mod, bool) and isinstance(
                mod, (int, float)
            ) and mod > 0:
                # Decimal modulo is exact for fractional divisors too,
                # so the enum/const filter enforces what the non-enum
                # compile path can only warn about
                if d % decimal.Decimal(str(mod)) != 0:
                    return False
        if isinstance(v, str):
            if len(v) < int(out.get("minLength", 0)):
                return False
            if "maxLength" in out and len(v) > int(out["maxLength"]):
                return False
            pat = out.get("pattern")
            if pat is not None:
                import re as _re

                try:
                    if not _re.search(pat, v):  # JSON Schema: unanchored
                        return False
                except _re.error:
                    raise ValueError(
                        f"allOf: cannot check enum/const against "
                        f"pattern {pat!r}"
                    )
        if isinstance(v, list):
            if len(v) < int(out.get("minItems", 0)):
                return False
            if "maxItems" in out and len(v) > int(out["maxItems"]):
                return False
            if out.get("uniqueItems"):
                canon = [
                    json.dumps(x, separators=(",", ":"), sort_keys=True)
                    for x in v
                ]
                if len(set(canon)) != len(canon):
                    return False
            items = out.get("items")
            if isinstance(items, dict) and not all(
                self._value_satisfies(x, self._resolve(items)) for x in v
            ):
                return False
        if isinstance(v, dict):
            if len(v) < int(out.get("minProperties", 0)):
                return False
            if "maxProperties" in out and len(v) > int(
                out["maxProperties"]
            ):
                return False
            props = out.get("properties", {})
            if props and not set(out.get("required", list(props))) <= set(
                v
            ):
                return False
            for name, sub in props.items():
                if name in v and not self._value_satisfies(
                    v[name], self._resolve(sub)
                ):
                    return False
            if out.get("additionalProperties") is False and not set(
                v
            ) <= set(props):
                return False
        return True

    def _expand_anyof(
        self, p: Dict[str, Any], depth: int = 0
    ) -> List[Dict[str, Any]]:
        """Flatten a conjunct into its anyOf alternatives, recursively —
        a nested anyOf must not survive to the key-merge loop, where a
        leftover ``anyOf`` key would make compile_node silently ignore
        every sibling constraint (widening)."""
        if depth > 8:
            raise ValueError("allOf: anyOf nesting too deep")
        p = dict(self._resolve(p))
        if "anyOf" not in p:
            return [p]
        rest = {k: v for k, v in p.items() if k != "anyOf"}
        out: List[Dict[str, Any]] = []
        for br in p["anyOf"]:
            for q in self._expand_anyof(br, depth + 1):
                out.append({"allOf": [q, rest]} if rest else q)
            if len(out) > 64:
                raise ValueError(
                    "allOf: anyOf distribution too large (max 64)"
                )
        return out

    def _merge_key(self, k: str, cur: Any, v: Any) -> Any:
        """Conjunction of two values of schema keyword ``k``."""
        if k in self._ANNOTATIONS:
            return v
        try:
            # canonical-JSON equality, NOT ==: True == 1 in Python, but
            # draft-4 boolean exclusiveMinimum and numeric 1 must not
            # take the fast path together (silent bound widening)
            if json.dumps(cur, sort_keys=True) == json.dumps(
                v, sort_keys=True
            ):
                return v
        except (TypeError, ValueError):
            if cur is v:
                return v
        if k == "required":
            return list(dict.fromkeys(list(cur) + list(v)))
        if k == "properties":
            merged = dict(cur)
            for name, s in v.items():
                if name in merged and not _same(merged[name], s):
                    merged[name] = {"allOf": [merged[name], s]}
                else:
                    merged[name] = s
            return merged
        if k in ("items", "additionalProperties") and isinstance(
            cur, dict
        ) and isinstance(v, dict):
            return {"allOf": [cur, v]}
        if k == "additionalProperties":
            # one side boolean: False wins (conjunction); True defers
            if cur is False or v is False:
                return False
            return cur if v is True else v
        if k == "type":
            def tset(t):
                return set(t) if isinstance(t, list) else {t}

            a, b = tset(cur), tset(v)
            # "number" admits integers: expand for the intersection,
            # then keep "number" only if both sides allowed it
            ea = a | ({"integer"} if "number" in a else set())
            eb = b | ({"integer"} if "number" in b else set())
            inter = ea & eb
            if not ("number" in a and "number" in b):
                inter.discard("number")
            if "number" in inter:
                inter.discard("integer")
            if not inter:
                raise ValueError(
                    f"allOf: empty type intersection ({cur!r} & {v!r})"
                )
            ordered = sorted(inter)
            return ordered[0] if len(ordered) == 1 else ordered
        if k in (
            "minimum", "minLength", "minItems", "minProperties",
        ):
            return max(cur, v)
        if k in (
            "maximum", "maxLength", "maxItems", "maxProperties",
        ):
            return min(cur, v)
        if k in ("exclusiveMinimum", "exclusiveMaximum"):
            if isinstance(cur, bool) or isinstance(v, bool):
                raise ValueError(
                    f"allOf: cannot intersect draft-4 boolean {k} "
                    "across conjuncts"
                )
            return max(cur, v) if k == "exclusiveMinimum" else min(cur, v)
        if k == "multipleOf":
            import math

            a, b = _integral(cur), _integral(v)
            if a is not None and b is not None and a > 0 and b > 0:
                return a * b // math.gcd(a, b)
            raise ValueError(
                f"allOf: cannot intersect multipleOf {cur!r} and {v!r} "
                "(supported: positive integers, via lcm)"
            )
        if k == "enum":
            have = {_canon(x) for x in cur}
            inter = [x for x in v if _canon(x) in have]
            if not inter:
                raise ValueError("allOf: empty enum intersection")
            return inter
        if k == "const":
            raise ValueError(
                f"allOf: conflicting const values {cur!r} and {v!r}"
            )
        if k in ("pattern", "format"):
            raise ValueError(
                f"allOf: two distinct {k} conjuncts cannot be "
                f"intersected ({cur!r} and {v!r})"
            )
        if k == "uniqueItems":
            return bool(cur) or bool(v)
        raise ValueError(
            f"allOf: unsupported intersection for keyword {k!r} "
            f"({cur!r} and {v!r})"
        )

    def _reaches_ref(self, schema: Any, target: str) -> bool:
        """True when ``target``'s $ref is reachable anywhere under
        ``schema`` WITHOUT passing through defs (the walk follows only
        inline structure; refs to other defs are expanded once each —
        cycles through intermediate defs count as reaching)."""

        def walk(node: Any, seen: frozenset) -> bool:
            if isinstance(node, dict):
                r = node.get("$ref")
                if isinstance(r, str):
                    name = r.split("/")[-1]
                    if name == target:
                        return True
                    if name in seen or name not in self.defs:
                        return False
                    return walk(self.defs[name], seen | {name})
                return any(walk(v, seen) for v in node.values())
            if isinstance(node, list):
                return any(walk(v, seen) for v in node)
            return False

        return walk(schema, frozenset())

    def _prune_recursion(
        self, schema: Any, target: str, expanding: frozenset = frozenset()
    ) -> Any:
        """Copy of ``schema`` with every branch that reaches ``target``
        removed (narrowing, never widening): optional properties drop,
        arrays close to maxItems 0 (when minItems allows), anyOf/oneOf
        keep their non-recursive arms. Intermediate defs on the way to
        ``target`` are expanded inline (``expanding`` breaks def
        cycles). Raises ValueError when recursion is structurally
        required."""
        if not isinstance(schema, dict):
            return schema
        if not self._reaches_ref(schema, target):
            return schema
        s = dict(schema)
        r = s.get("$ref")
        if isinstance(r, str):
            name = r.split("/")[-1]
            if name == target:
                raise ValueError(
                    f"recursive schema: $ref {target!r} is required at "
                    f"depth {self.MAX_REF_DEPTH} with no finite "
                    "alternative"
                )
            if name in expanding:
                raise ValueError(
                    f"recursive schema: def cycle through {name!r} "
                    f"reaches {target!r} at the depth limit"
                )
            if name in self.defs:
                # expand the intermediate def inline and prune the
                # copy — a cycle back to target must terminate HERE,
                # not spin through another round of compile_node
                rest = {k: v for k, v in s.items() if k != "$ref"}
                expanded = self._prune_recursion(
                    self.defs[name], target, expanding | {name}
                )
                if rest:
                    rest = self._prune_recursion(
                        rest, target, expanding
                    )
                    return {"allOf": [expanded, rest]}
                return expanded
        for comb in ("anyOf", "oneOf"):
            if comb in s:
                kept = []
                for br in s[comb]:
                    try:
                        kept.append(self._prune_recursion(br, target, expanding))
                    except ValueError:
                        continue
                if not kept:
                    raise ValueError(
                        f"recursive schema: every {comb} arm reaches "
                        f"{target!r} at the depth limit"
                    )
                s[comb] = kept
        if "allOf" in s:
            s["allOf"] = [
                self._prune_recursion(br, target, expanding)
                for br in s["allOf"]
            ]
        if isinstance(s.get("items"), dict) and self._reaches_ref(
            s["items"], target
        ):
            try:
                s["items"] = self._prune_recursion(
                    s["items"], target, expanding
                )
            except ValueError:
                if int(s.get("minItems", 0)) > 0:
                    raise ValueError(
                        f"recursive schema: array of {target!r} requires "
                        "items at the depth limit"
                    )
                # close the array: [] stays valid; drop the item schema
                # (never emitted at length 0) so the final
                # reaches-check below doesn't see a ghost reference
                s["maxItems"] = 0
                s["items"] = {}
        if "properties" in s:
            props = dict(s["properties"])
            required = set(s.get("required", list(props)))
            for name in list(props):
                if not self._reaches_ref(props[name], target):
                    continue
                try:
                    props[name] = self._prune_recursion(
                        props[name], target, expanding
                    )
                except ValueError:
                    if name in required:
                        raise ValueError(
                            f"recursive schema: required property "
                            f"{name!r} reaches {target!r} at the depth "
                            "limit with no finite alternative"
                        )
                    del props[name]
            s["properties"] = props
            s["required"] = [n for n in required if n in props]
        addl = s.get("additionalProperties")
        if isinstance(addl, dict) and self._reaches_ref(addl, target):
            try:
                s["additionalProperties"] = self._prune_recursion(
                    addl, target, expanding
                )
            except ValueError:
                if int(s.get("minProperties", 0)) > 0:
                    raise ValueError(
                        f"recursive schema: map values reach {target!r} "
                        "at the depth limit but minProperties > 0"
                    )
                # close the map: {} stays valid
                s["additionalProperties"] = False
        # termination guarantee: whatever keyword carried the recursion,
        # a "pruned" schema that still reaches the target would send
        # compile_node into the same loop this function exists to break
        if self._reaches_ref(s, target):
            raise ValueError(
                f"recursive schema: cannot finitely unroll the "
                f"reference to {target!r} (unsupported keyword carries "
                "the recursion)"
            )
        return s

    def _entering_refs(self, schema: Any) -> List[str]:
        """Def names ``_resolve``/``_merge_allof`` will expand INLINE at
        this node: a top-level $ref, and $refs anywhere in a top-level
        allOf chain (the Pydantic field-metadata wrapper shape). These
        are what the depth counter must track — deeper refs reach their
        own compile_node call."""
        names: List[str] = []
        if not isinstance(schema, dict):
            return names
        r = schema.get("$ref")
        if isinstance(r, str):
            name = r.split("/")[-1]
            if name in self.defs:
                names.append(name)
        for br in schema.get("allOf", []) or []:
            names.extend(self._entering_refs(br))
        return names

    def _cap_refs(self, schema: Any, targets: set) -> Any:
        """Replace top-level/allOf-chain $refs to ``targets`` with their
        pruned (recursion-free) definitions."""
        if not isinstance(schema, dict):
            return schema
        r = schema.get("$ref")
        if isinstance(r, str) and r.split("/")[-1] in targets:
            name = r.split("/")[-1]
            pruned = self._prune_recursion(self.defs[name], name)
            rest = {k: v for k, v in schema.items() if k != "$ref"}
            if rest:
                rest = self._prune_recursion(rest, name)
                return {"allOf": [pruned, rest]}
            return pruned
        if "allOf" in schema:
            schema = dict(schema)
            schema["allOf"] = [
                self._cap_refs(br, targets) for br in schema["allOf"]
            ]
        return schema

    def compile_node(self, schema: Dict[str, Any]) -> Frag:
        # bounded unrolling for recursive $refs: track every def this
        # node expands inline; at the cap, compile the pruned
        # (recursion-free) variant instead of recursing forever
        names = self._entering_refs(schema)
        over = {n for n in names if
                self._ref_stack.count(n) >= self.MAX_REF_DEPTH}
        if over:
            schema = self._cap_refs(schema, over)
            names = [n for n in names if n not in over]
        self._ref_stack.extend(names)
        try:
            return self._compile_node_inner(schema)
        finally:
            if names:
                del self._ref_stack[-len(names):]

    def _compile_node_inner(self, schema: Dict[str, Any]) -> Frag:
        b = self.b
        schema = self._resolve(schema)

        if "enum" in schema:
            return b.alt(
                *[
                    # canonical no-whitespace form, like every other
                    # structured emission in this compiler
                    b.lit(
                        json.dumps(v, separators=(",", ":")).encode()
                    )
                    for v in schema["enum"]
                ]
            )
        if "const" in schema:
            return b.lit(
                json.dumps(schema["const"], separators=(",", ":")).encode()
            )
        for comb in ("anyOf", "oneOf"):
            if comb in schema:
                return b.alt(
                    *[self.compile_node(s) for s in schema[comb]]
                )

        t = schema.get("type")
        if isinstance(t, list):
            return b.alt(
                *[self.compile_node({**schema, "type": tt}) for tt in t]
            )
        if t == "string":
            if "pattern" in schema:
                frag = self._pattern_frag(schema["pattern"])
                if frag is not None:
                    if (
                        "minLength" in schema or "maxLength" in schema
                    ) and _pattern_proves_bounds(
                        schema["pattern"], schema
                    ) is False:
                        # pattern wins (docstring on _pattern_frag) —
                        # but be honest about it when the pattern does
                        # not provably satisfy the bounds (the allOf
                        # merge hard-fails this; a directly-authored
                        # schema keeps the documented precedence)
                        import warnings

                        warnings.warn(
                            "output_schema: pattern "
                            f"{schema['pattern']!r} takes precedence"
                            " over minLength/maxLength (bounds not "
                            "provably satisfied — outputs may "
                            "violate them)",
                            stacklevel=2,
                        )
                    return frag
            if (
                schema.get("format") in _FORMAT_PATTERNS
                # a validator enforces minLength/maxLength but treats
                # format as annotation — when both appear, the length
                # bounds must win or generated values could fail the
                # user's own validation
                and "minLength" not in schema
                and "maxLength" not in schema
            ):
                # JSON Schema treats format as annotation, but schema-
                # constrained users expect e.g. a Pydantic UUID field to
                # BE a UUID — enforce the well-known ones via the same
                # regex path (canonical textual forms). Also the
                # fallback when a user pattern fails to compile: closer
                # than an unconstrained string.
                frag = self._pattern_frag(
                    _FORMAT_PATTERNS[schema["format"]]
                )
                if frag is not None:
                    return frag
            return self._string_frag(
                min_len=int(schema.get("minLength", 0)),
                max_len=(
                    int(schema["maxLength"]) if "maxLength" in schema else None
                ),
            )
        if t == "integer":
            lo, hi = _integer_bounds(schema)
            mod = schema.get("multipleOf")
            # NOTE: no float() on arbitrary ints — json can carry
            # integers too large to convert (OverflowError)
            if isinstance(mod, bool):
                mod_ok = False
            elif isinstance(mod, int):
                mod_ok = 1 <= mod <= 512
            elif isinstance(mod, float):
                mod_ok = mod.is_integer() and 1 <= int(mod) <= 512
            else:
                mod_ok = False
            if mod is not None and mod_ok:
                mod = int(mod)
            elif mod is not None:
                # fractional or huge multipleOf: out of the automaton's
                # scope — bounds still enforced, divisibility is not
                import warnings

                warnings.warn(
                    f"integer multipleOf {mod!r} not enforced "
                    "(supported: integer 1..512)",
                    stacklevel=2,
                )
                mod = None
            if mod == 1:
                mod = None  # every integer qualifies
            if lo is not None or hi is not None or mod is not None:
                return self._bounded_int_frag(lo, hi, mod)
            return self._integer_frag()
        if t == "number":
            if schema.get("multipleOf") is not None:
                import warnings

                warnings.warn(
                    "number multipleOf is not enforced by constrained "
                    "decoding (bounds still are)",
                    stacklevel=2,
                )
            nlo, n_open_lo, nhi, n_open_hi = _number_bounds(schema)
            if nlo is not None or nhi is not None:
                return self._bounded_number_frag(
                    nlo, nhi, open_lo=n_open_lo, open_hi=n_open_hi
                )
            return self._number_frag()
        if t == "boolean":
            return b.alt(b.lit(b"true"), b.lit(b"false"))
        if t == "null":
            return b.lit(b"null")
        if t == "array":
            return self._array_frag(schema)
        if t == "object" or "properties" in schema:
            return self._object_frag(schema)
        # untyped: any JSON scalar (string | number | boolean | null)
        return b.alt(
            self._string_frag(),
            self._number_frag(),
            b.lit(b"true"),
            b.lit(b"false"),
            b.lit(b"null"),
        )

    def _array_frag(self, schema: Dict[str, Any]) -> Frag:
        b = self.b
        item_schema = schema.get("items", {})
        min_items = int(schema.get("minItems", 0))
        max_items = schema.get("maxItems")

        def item() -> Frag:
            return self.compile_node(item_schema)

        if schema.get("uniqueItems"):
            resolved = self._resolve(item_schema)
            values = resolved.get("enum")
            if values is not None:
                # dedupe by canonical serialization first: a schema
                # enum like ["a", "a", "b"] or [1, 1.0] has positional
                # duplicates that permutations() would treat as
                # distinct, producing repeat-carrying "arrangements"
                seen = set()
                uniq = []
                for v in values:
                    k = json.dumps(v, separators=(",", ":"))
                    if k not in seen:
                        seen.add(k)
                        uniq.append(v)
                values = uniq
            if values is not None and len(values) <= 5:
                # small enum item pools: enumerate the DISTINCT ordered
                # arrangements directly (sum of P(n, k) over the size
                # range — <= 325 alternatives at n=5), so repeats are
                # impossible by construction. Larger pools / non-enum
                # items fall through with a warning: type-valid arrays,
                # uniqueness unchecked.
                from itertools import permutations

                n = len(values)
                lo_k = min_items
                hi_k = min(int(max_items), n) if max_items is not None else n
                arrangements = [
                    list(p)
                    for k in range(lo_k, hi_k + 1)
                    for p in permutations(values, k)
                ]
                if not arrangements:
                    raise ValueError(
                        f"uniqueItems array needs {min_items}+ of "
                        f"{n} distinct enum values"
                    )
                return b.alt(
                    *[
                        b.lit(
                            json.dumps(a, separators=(",", ":")).encode()
                        )
                        for a in arrangements
                    ]
                )
            import warnings

            warnings.warn(
                "uniqueItems not enforced (supported: enum items with "
                "<=5 values)",
                stacklevel=2,
            )

        if max_items is not None and int(max_items) <= 16:
            # bounded unrolling for small fixed sizes
            alts = []
            for n in range(min_items, int(max_items) + 1):
                if n == 0:
                    alts.append(b.lit(b"[]"))
                else:
                    parts: List[Frag] = [b.lit(b"[")]
                    for i in range(n):
                        if i:
                            parts.append(b.lit(b","))
                        parts.append(item())
                    parts.append(b.lit(b"]"))
                    alts.append(b.seq(*parts))
            return b.alt(*alts)

        rest = b.star(b.seq(b.lit(b","), item()))
        required_head: List[Frag] = [item()]
        for _ in range(max(min_items - 1, 0)):
            required_head.append(b.seq(b.lit(b","), item()))
        nonempty = b.seq(b.lit(b"["), *required_head, rest, b.lit(b"]"))
        if min_items > 0:
            return nonempty
        return b.alt(b.lit(b"[]"), nonempty)

    def _object_frag(self, schema: Dict[str, Any]) -> Frag:
        b = self.b
        props: Dict[str, Any] = schema.get("properties", {})
        required = set(schema.get("required", list(props)))
        if not props:
            addl = schema.get("additionalProperties")
            if isinstance(addl, dict) or addl is True:
                # free-form map (Pydantic Dict[str, T]): generated keys
                # with schema'd values. Declared-property objects never
                # emit extras (closure by construction — see below), so
                # this path only applies to pure maps.
                return self._freeform_object_frag(
                    schema, addl if isinstance(addl, dict) else {}
                )
            return b.lit(b"{}")
        # NOTE additionalProperties closure: this automaton emits ONLY
        # the declared properties (canonical key order), so output can
        # never contain an extra key — `additionalProperties: false` is
        # enforced by construction, and any additionalProperties schema
        # is trivially satisfied (subset discipline: omitting optional
        # extras is always valid).

        # Emit keys in properties order. Optional properties branch.
        # Build right-to-left: frag(i) = rest of object from property i on,
        # given whether any property has been emitted yet (comma handling).
        names = list(props)
        memo: Dict[Tuple[int, bool], Frag] = {}

        def tail(i: int, emitted_before: bool) -> Frag:
            # memoized: NFA fragments are graphs, so sharing a tail between
            # the "with property" and "skip property" branches is free and
            # keeps construction linear in #properties
            cached = memo.get((i, emitted_before))
            if cached is not None:
                return cached
            frag = _tail(i, emitted_before)
            memo[(i, emitted_before)] = frag
            return frag

        def _tail(i: int, emitted_before: bool) -> Frag:
            if i == len(names):
                return b.lit(b"}")
            name = names[i]
            keylit = json.dumps(name).encode() + b":"  # noqa: E501 — canonical, no spaces
            prefix = (b"," if emitted_before else b"") + keylit
            with_prop = b.seq(
                b.lit(prefix),
                self.compile_node(props[name]),
                tail(i + 1, True),
            )
            if name in required:
                return with_prop
            return b.alt(with_prop, tail(i + 1, emitted_before))

        return b.seq(b.lit(b"{"), tail(0, False))

    def _freeform_object_frag(
        self, schema: Dict[str, Any], value_schema: Dict[str, Any]
    ) -> Frag:
        """``{"<string>": <value>, ...}`` for property-less objects with
        an ``additionalProperties`` schema. Key uniqueness is not
        expressible in an NFA; duplicate keys are syntactically valid
        JSON (parsers keep the last), so output still parses and the
        parsed object validates against the value schema."""
        b = self.b
        min_p = int(schema.get("minProperties", 0))
        max_p = schema.get("maxProperties")
        req = list(schema.get("required", []))

        def pair() -> Frag:
            return b.seq(
                self._string_frag(),
                b.lit(b":"),
                self.compile_node(value_schema),
            )

        if req:
            # required keys on a property-less map: emit them literally
            # (in order) before any free-form extras, so output always
            # carries them
            if max_p is not None and len(req) > int(max_p):
                raise ValueError(
                    "required keys exceed maxProperties on free-form map"
                )
            head: List[Frag] = []
            for i, name in enumerate(req):
                if i:
                    head.append(b.lit(b","))
                head.append(
                    b.seq(
                        b.lit(json.dumps(name).encode() + b":"),
                        self.compile_node(value_schema),
                    )
                )
            extras_min = max(min_p - len(req), 0)
            if max_p is None:
                tail: Frag = b.star(b.seq(b.lit(b","), pair()))
                for _ in range(extras_min):
                    head.append(b.seq(b.lit(b","), pair()))
                head.append(tail)
            else:
                for _ in range(extras_min):
                    head.append(b.seq(b.lit(b","), pair()))
                opt_tail: Optional[Frag] = None
                for _ in range(int(max_p) - len(req) - extras_min):
                    piece = b.seq(b.lit(b","), pair())
                    opt_tail = (
                        b.opt(piece)
                        if opt_tail is None
                        else b.opt(b.seq(piece, opt_tail))
                    )
                if opt_tail is not None:
                    head.append(opt_tail)
            return b.seq(b.lit(b"{"), *head, b.lit(b"}"))

        if max_p is not None:
            max_p = int(max_p)
            if min_p > max_p:
                raise ValueError("minProperties exceeds maxProperties")
            if max_p == 0:
                return b.lit(b"{}")
            # exact bound at any size: required head + nested optional
            # tail (linear in max_p, same shape as bounded strings)
            n_req = max(min_p, 1)
            head: List[Frag] = [pair()]
            for _ in range(n_req - 1):
                head.append(b.seq(b.lit(b","), pair()))
            opt_tail: Optional[Frag] = None
            for _ in range(max_p - n_req):
                piece = b.seq(b.lit(b","), pair())
                opt_tail = (
                    b.opt(piece)
                    if opt_tail is None
                    else b.opt(b.seq(piece, opt_tail))
                )
            if opt_tail is not None:
                head.append(opt_tail)
            nonempty = b.seq(b.lit(b"{"), *head, b.lit(b"}"))
            if min_p > 0:
                return nonempty
            return b.alt(b.lit(b"{}"), nonempty)

        head = [pair()]
        for _ in range(max(min_p - 1, 0)):
            head.append(b.seq(b.lit(b","), pair()))
        rest = b.star(b.seq(b.lit(b","), pair()))
        nonempty = b.seq(b.lit(b"{"), *head, rest, b.lit(b"}"))
        if min_p > 0:
            return nonempty
        return b.alt(b.lit(b"{}"), nonempty)

    def compile(self) -> NFA:
        return self.b.build(self.compile_node(self.schema))


def _number_bounds(schema: Dict[str, Any]):
    """Effective (lo, open_lo, hi, open_hi) for a number schema as
    Decimals + strictness flags. Numeric exclusive bounds (draft 2020)
    apply independently of minimum/maximum; the draft-4 boolean form
    flips the adjacent bound strict. The tightest combination wins, and
    a strict bound at the same value as a closed one stays strict."""
    import decimal

    def dec(v):
        # non-finite bounds (a Python-dict schema can carry float inf/
        # nan) constrain nothing — treat as the open side
        if v is None:
            return None
        d = decimal.Decimal(str(v))
        return d if d.is_finite() else None

    lo = dec(schema.get("minimum"))
    hi = dec(schema.get("maximum"))
    open_lo = open_hi = False

    emin = schema.get("exclusiveMinimum")
    if isinstance(emin, bool):
        open_lo = emin and lo is not None
    else:
        v = dec(emin)
        if v is not None and (lo is None or v >= lo):
            lo, open_lo = v, True
    emax = schema.get("exclusiveMaximum")
    if isinstance(emax, bool):
        open_hi = emax and hi is not None
    else:
        v = dec(emax)
        if v is not None and (hi is None or v <= hi):
            hi, open_hi = v, True
    return lo, open_lo, hi, open_hi


def _integer_bounds(
    schema: Dict[str, Any]
) -> Tuple[Optional[int], Optional[int]]:
    """Effective integer [lo, hi] from minimum/maximum and BOTH exclusive
    forms: draft-2020 numeric exclusiveMinimum/Maximum apply
    *independently* of minimum/maximum (intersect, don't overwrite), and
    the draft-4 boolean form flips the adjacent bound to exclusive.
    Fractional bounds round INWARD (ceil for lower, floor for upper) so
    the automaton never accepts an out-of-range integer."""
    import math

    lo = schema.get("minimum")
    hi = schema.get("maximum")
    lo = None if lo is None else math.ceil(lo)
    hi = None if hi is None else math.floor(hi)

    def tighten_lo(v: Optional[int]) -> None:
        nonlocal lo
        if v is not None:
            lo = v if lo is None else max(lo, v)

    def tighten_hi(v: Optional[int]) -> None:
        nonlocal hi
        if v is not None:
            hi = v if hi is None else min(hi, v)

    # v > b  =>  smallest integer floor(b)+1 (integral and fractional b);
    # v < b  =>  largest integer ceil(b)-1
    emin = schema.get("exclusiveMinimum")
    if isinstance(emin, bool):
        if emin and schema.get("minimum") is not None:
            lo = math.floor(schema["minimum"]) + 1
    elif emin is not None:
        tighten_lo(math.floor(emin) + 1)
    emax = schema.get("exclusiveMaximum")
    if isinstance(emax, bool):
        if emax and schema.get("maximum") is not None:
            hi = math.ceil(schema["maximum"]) - 1
    elif emax is not None:
        tighten_hi(math.ceil(emax) - 1)
    return lo, hi


def compile_schema(schema: Dict[str, Any]) -> NFA:
    return SchemaCompiler(schema).compile()
