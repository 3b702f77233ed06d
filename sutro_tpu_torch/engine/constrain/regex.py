"""Regex -> byte-NFA fragments for JSON-schema ``pattern`` strings.

Compiles an ECMA-regex subset onto the same Thompson ``Builder`` the
schema compiler uses (nfa.py), producing fragments over the JSON-ENCODED
bytes between the quotes of a string value: a pattern character that is
JSON-special (``"``, ``\\``, control chars) matches its canonical JSON
escape sequence, so the automaton can never emit an invalid string body.

Subset discipline: constrained decoding must emit a SUBSET of the
schema's language, never a superset — so where ECMA semantics allow more
than we can model over canonical JSON bytes, we restrict:

- ``.`` and negated classes match printable ASCII only (no multi-byte
  UTF-8, no escape sequences) — a deliberate canonicalization;
- class members / literals outside printable ASCII + ``\\t\\n\\r\\f\\v``
  raise :class:`UnsupportedPattern`;
- JSON Schema patterns are UNANCHORED (match anywhere in the string);
  honoring that exactly requires arbitrary prefix/suffix, which the
  schema compiler supplies via its string-char fragment. ``^``/``$`` at
  the ends anchor as usual; anchors elsewhere are unsupported.

Unsupported constructs raise :class:`UnsupportedPattern`; the schema
compiler catches it and falls back to the unconstrained string fragment
(the pre-pattern behavior), keeping schemas loadable.

Supported: literals, ``.``, ``[...]``/``[^...]`` with ranges,
``\\d \\D \\w \\W \\s \\S``, escaped metacharacters, ``* + ?``,
``{m} {m,} {m,n}`` (n <= 256), alternation ``|``, groups ``( )`` and
``(?: )``.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np

from .nfa import Builder, bitmap_of

Frag = Tuple[int, int]

# printable ASCII that is legal raw inside a JSON string
_PLAIN = np.zeros(256, bool)
_PLAIN[0x20:0x7F] = True
_PLAIN[0x22] = False  # '"'
_PLAIN[0x5C] = False  # '\'

# regex-accessible control chars -> canonical JSON escape
_CTRL_ESC = {
    0x08: b"\\b", 0x09: b"\\t", 0x0A: b"\\n",
    0x0C: b"\\f", 0x0D: b"\\r",
}
_META = set(b".^$*+?()[]{}|\\")

_DIGITS = np.zeros(256, bool)
_DIGITS[0x30:0x3A] = True
_WORD = _DIGITS.copy()
_WORD[0x41:0x5B] = True
_WORD[0x61:0x7B] = True
_WORD[0x5F] = True
_SPACE_BYTES = (0x20, 0x09, 0x0A, 0x0C, 0x0D, 0x0B)


class UnsupportedPattern(ValueError):
    pass


_SHORT_ESC = {
    ord("t"): 0x09, ord("n"): 0x0A, ord("r"): 0x0D,
    ord("f"): 0x0C, ord("v"): 0x0B,
}


def _escape_literal(e: int, *, in_class: bool) -> int:
    """Single resolver for ``\\<e>`` as a literal byte, shared by
    parse_atom and character-class parsing so the two cannot drift:
    short escapes map, metachars and non-plain bytes are literals, and
    anything else (``\\x``, ``\\u``, ``\\A``, backrefs, ...) raises
    rather than silently degrading to the escape letter itself. Inside
    a class, escaped punctuation (``\\-``, ``\\!``) is additionally a
    literal — the one context-dependent rule."""
    lit = _SHORT_ESC.get(e)
    if lit == 0x0B:
        raise UnsupportedPattern(r"\v has no JSON short escape")
    if lit is not None:
        return lit
    if e == -1:
        raise UnsupportedPattern("dangling escape")
    if e in _META or not _PLAIN[e]:
        return e
    # inside a class: escaped punctuation (\- \!) and \_ (underscore is
    # the one _WORD member that is not alphanumeric; ECMA keeps it a
    # literal) — alphanumerics (\x, \u, \A, backrefs) stay errors
    if in_class and (not _WORD[e] or e == 0x5F):
        return e
    raise UnsupportedPattern(f"unsupported escape \\{chr(e)}")


class _CharSet:
    """A single-character matcher: plain-byte bitmap + JSON-escaped
    control members (each matched as its escape literal)."""

    def __init__(self) -> None:
        self.plain = np.zeros(256, bool)
        self.ctrl: set = set()

    def add_byte(self, c: int) -> None:
        if _PLAIN[c]:
            self.plain[c] = True
        elif c in _CTRL_ESC:
            self.ctrl.add(c)
        elif c == 0x22:   # '"' raw is illegal in the body — use escape
            self.ctrl.add(c)
        elif c == 0x5C:
            self.ctrl.add(c)
        else:
            raise UnsupportedPattern(
                f"pattern char 0x{c:02x} outside the supported alphabet"
            )

    def add_class(self, bm: np.ndarray) -> None:
        self.plain |= bm & _PLAIN
        for c in _SPACE_BYTES:
            if bm[c] and not _PLAIN[c] and c in _CTRL_ESC:
                self.ctrl.add(c)

    def negate(self) -> None:
        # complement within printable ASCII only (subset discipline)
        self.plain = _PLAIN & ~self.plain
        self.ctrl = set()

    def frag(self, b: Builder) -> Frag:
        alts: List[Frag] = []
        if self.plain.any():
            alts.append(b.char(self.plain.copy()))
        for c in sorted(self.ctrl):
            if c == 0x22:
                alts.append(b.lit(b'\\"'))
            elif c == 0x5C:
                alts.append(b.lit(b"\\\\"))
            else:
                alts.append(b.lit(_CTRL_ESC[c]))
        if not alts:
            raise UnsupportedPattern("empty character class")
        return alts[0] if len(alts) == 1 else b.alt(*alts)


def _escape_set(c: int) -> Optional[np.ndarray]:
    if c == ord("d"):
        return _DIGITS.copy()
    if c == ord("D"):
        return _PLAIN & ~_DIGITS
    if c == ord("w"):
        return _WORD.copy()
    if c == ord("W"):
        return _PLAIN & ~_WORD
    if c == ord("s"):
        m = np.zeros(256, bool)
        for x in _SPACE_BYTES:
            m[x] = True
        return m
    if c == ord("S"):
        return _PLAIN & ~bitmap_of(bytes([0x20]))
    return None


class _Parser:
    def __init__(self, b: Builder, pattern: str):
        self.b = b
        try:
            self.src = pattern.encode("ascii")
        except UnicodeEncodeError as e:
            raise UnsupportedPattern(
                "non-ASCII pattern characters are unsupported"
            ) from e
        self.i = 0

    def peek(self) -> int:
        return self.src[self.i] if self.i < len(self.src) else -1

    def take(self) -> int:
        c = self.peek()
        self.i += 1
        return c

    # alt := concat ('|' concat)*
    def parse_alt(self) -> Frag:
        parts = [self.parse_concat()]
        while self.peek() == ord("|"):
            self.take()
            parts.append(self.parse_concat())
        return parts[0] if len(parts) == 1 else self.b.alt(*parts)

    def parse_concat(self) -> Frag:
        frags: List[Frag] = []
        while self.peek() not in (-1, ord("|"), ord(")")):
            frags.append(self.parse_repeat())
        return self.b.seq(*frags)

    def parse_repeat(self) -> Frag:
        atom_fn = self.parse_atom()
        c = self.peek()
        if c == ord("*"):
            self.take()
            return self.b.star(atom_fn())
        if c == ord("+"):
            self.take()
            return self.b.plus(atom_fn())
        if c == ord("?"):
            self.take()
            return self.b.opt(atom_fn())
        if c == ord("{"):
            return self._parse_braces(atom_fn)
        return atom_fn()

    def _parse_braces(self, atom_fn: Callable[[], Frag]) -> Frag:
        self.take()  # '{'
        start = self.i
        while self.peek() not in (-1, ord("}")):
            self.take()
        if self.peek() != ord("}"):
            raise UnsupportedPattern("unterminated {quantifier}")
        body = self.src[start: self.i].decode()
        self.take()  # '}'
        try:
            if "," in body:
                lo_s, hi_s = body.split(",", 1)
                lo = int(lo_s) if lo_s else 0
                hi = int(hi_s) if hi_s else None
            else:
                lo = hi = int(body)
        except ValueError as e:
            # ECMA treats malformed braces as literals; modeling that is
            # not worth it — degrade via the documented fallback
            raise UnsupportedPattern(
                f"malformed {{quantifier}}: {{{body}}}"
            ) from e
        if lo < 0 or lo > 256 or (
            hi is not None and (hi < lo or hi > 256)
        ):
            raise UnsupportedPattern(f"{{m,n}} out of range: {body}")
        b = self.b
        frags = [atom_fn() for _ in range(lo)]
        if hi is None:
            frags.append(b.star(atom_fn()))
        else:
            tail: Optional[Frag] = None
            for _ in range(hi - lo):
                piece = atom_fn()
                tail = b.opt(piece if tail is None else b.seq(piece, tail))
            if tail is not None:
                frags.append(tail)
        return b.seq(*frags)

    # returns a THUNK so {m,n} can instantiate the atom repeatedly
    # (fragments are single-use graph nodes)
    def parse_atom(self) -> Callable[[], Frag]:
        b = self.b
        c = self.take()
        if c == -1:
            raise UnsupportedPattern("unexpected end of pattern")
        if c == ord("("):
            if self.peek() == ord("?"):
                self.take()
                if self.peek() != ord(":"):
                    raise UnsupportedPattern(
                        "only (?:...) groups are supported"
                    )
                self.take()
            start = self.i
            frag = self.parse_alt()
            if self.take() != ord(")"):
                raise UnsupportedPattern("unbalanced group")
            end = self.i - 1
            sub = self.src[start:end].decode()

            def group(sub=sub) -> Frag:
                p = _Parser(b, sub)
                f = p.parse_alt()
                if p.i != len(p.src):
                    raise UnsupportedPattern("unbalanced group body")
                return f

            # the first instantiation was already built; re-parse on
            # subsequent calls (rare: only under {m,n})
            first = [frag]

            def thunk() -> Frag:
                if first:
                    return first.pop()
                return group()

            return thunk
        if c == ord("."):
            def dot() -> Frag:
                cs = _CharSet()
                cs.add_class(_PLAIN.copy())
                return cs.frag(b)
            return dot
        if c == ord("["):
            spec = self._parse_class_spec()

            def cls(spec=spec) -> Frag:
                return self._class_frag(spec)

            return cls
        if c == ord("\\"):
            e = self.take()
            if e == -1:
                raise UnsupportedPattern("trailing backslash")
            cls_bm = _escape_set(e)
            if cls_bm is not None:
                def esc_cls(bm=cls_bm) -> Frag:
                    cs = _CharSet()
                    cs.add_class(bm)
                    return cs.frag(b)
                return esc_cls
            lit = _escape_literal(e, in_class=False)

            def esc_lit(x=lit) -> Frag:
                cs = _CharSet()
                cs.add_byte(x)
                return cs.frag(b)

            return esc_lit
        if c in (ord("^"), ord("$")):
            raise UnsupportedPattern("inner anchors are unsupported")
        if c in (ord("*"), ord("+"), ord("?"), ord("{")):
            raise UnsupportedPattern("quantifier with no atom")

        def literal(x=c) -> Frag:
            cs = _CharSet()
            cs.add_byte(x)
            return cs.frag(b)

        return literal

    def _parse_class_spec(self):
        """Parse [...] into (negated, members) where members are bytes
        and (lo, hi) ranges and class-escape bitmaps."""
        negated = False
        if self.peek() == ord("^"):
            self.take()
            negated = True
        members: List = []
        first = True
        while True:
            c = self.take()
            if c == -1:
                raise UnsupportedPattern("unterminated character class")
            if c == ord("]") and not first:
                break
            first = False
            if c == ord("\\"):
                e = self.take()
                bm = _escape_set(e)
                if bm is not None:
                    members.append(("class", bm))
                    continue
                c = _escape_literal(e, in_class=True)
            if self.peek() == ord("-") and self.i + 1 < len(self.src) \
                    and self.src[self.i + 1] != ord("]"):
                self.take()  # '-'
                hi = self.take()
                if hi == ord("\\"):
                    hi = _escape_literal(self.take(), in_class=True)
                members.append(("range", c, hi))
            else:
                members.append(("byte", c))
        return negated, members

    def _class_frag(self, spec) -> Frag:
        negated, members = spec
        cs = _CharSet()
        for m in members:
            if m[0] == "byte":
                cs.add_byte(m[1])
            elif m[0] == "range":
                lo, hi = m[1], m[2]
                if hi < lo:
                    raise UnsupportedPattern("reversed class range")
                for x in range(lo, hi + 1):
                    cs.add_byte(x)
            else:
                cs.add_class(m[1])
        if negated:
            cs.negate()
        return cs.frag(self.b)


class _BoundsBuilder:
    """Duck-typed ``Builder`` substitute whose "fragments" are
    ``(lo, hi)`` CHARACTER-count bounds (``hi is None`` = unbounded).
    Running :func:`compile_pattern` against it computes the min/max
    match length of a pattern's language through the exact same parse
    the NFA build uses — one grammar, no drift. Every ``lit`` the
    pattern compiler emits is a single escaped character (``\\"``,
    ``\\\\``, control escapes), so it counts as one unit — the same
    escaped-chars-as-codepoints proxy ``_string_frag`` uses for
    minLength/maxLength."""

    @staticmethod
    def char(bm) -> Frag:
        return (1, 1)

    @staticmethod
    def lit(bs) -> Frag:
        return (1, 1)

    @staticmethod
    def seq(*fs) -> Frag:
        lo = sum(f[0] for f in fs)
        hi: Optional[int] = 0
        for f in fs:
            if f[1] is None:
                hi = None
                break
            hi += f[1]
        return (lo, hi)

    @staticmethod
    def alt(*fs) -> Frag:
        his = [f[1] for f in fs]
        return (
            min(f[0] for f in fs),
            None if any(h is None for h in his) else max(his),
        )

    @staticmethod
    def star(f) -> Frag:
        return (0, 0 if f[1] == 0 else None)

    @staticmethod
    def plus(f) -> Frag:
        return (f[0], 0 if f[1] == 0 else None)

    @staticmethod
    def opt(f) -> Frag:
        return (0, f[1])


def pattern_length_bounds(pattern: str) -> Tuple[int, Optional[int]]:
    """(min, max) character-length bounds of the language the compiled
    automaton for ``pattern`` matches; ``max is None`` = unbounded.
    Unanchored ends contribute their star-wrapped prefix/suffix exactly
    as the real compilation does (so an unanchored pattern is always
    unbounded above). Raises :class:`UnsupportedPattern` for constructs
    outside the subset — callers treat that as "cannot prove"."""
    return compile_pattern(_BoundsBuilder(), pattern, lambda: (1, 1))


def compile_pattern(
    b: Builder,
    pattern: str,
    string_char: Callable[[], Frag],
) -> Frag:
    """Compile a JSON-schema ``pattern`` into a fragment over the bytes
    BETWEEN the quotes of the JSON string value.

    JSON Schema patterns are unanchored — ``"ab"`` matches any string
    containing "ab" — so unless the pattern starts with ``^`` / ends
    with ``$``, the fragment is wrapped with arbitrary string-char
    prefix/suffix (``string_char`` supplies the schema compiler's full
    escaped/UTF-8 character fragment)."""
    anchored_start = pattern.startswith("^")
    anchored_end = pattern.endswith("$") and not pattern.endswith("\\$")
    body = pattern[1 if anchored_start else 0:]
    if anchored_end:
        body = body[:-1]
    p = _Parser(b, body)
    frag = p.parse_alt()
    if p.i != len(p.src):
        raise UnsupportedPattern("trailing characters in pattern")
    parts: List[Frag] = []
    if not anchored_start:
        parts.append(b.star(string_char()))
    parts.append(frag)
    if not anchored_end:
        parts.append(b.star(string_char()))
    return b.seq(*parts)
