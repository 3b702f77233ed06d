"""Tokenizer layer.

The reference has no tokenizer (token counting happens server-side; SURVEY
§2.3) — the TPU build needs one for prefill, honest ``truncate_rows``
(reference sdk.py:457,480), dry-run cost estimation (sdk.py:245-262), and
constrained decoding (token-level FSM needs per-token byte strings).

Two implementations behind one interface:

- ``HFTokenizer`` — loads a local HuggingFace ``tokenizer.json`` via the
  ``tokenizers`` library (works for the whole Qwen3/Llama/Gemma/gpt-oss
  catalog when a checkpoint dir is available).
- ``ByteTokenizer`` — dependency-free byte-level tokenizer (vocab = 256
  bytes + specials) used for tests and random-weight tiny models; also the
  worst-case-honest token counter when no checkpoint is present.

Both expose ``token_bytes(id)`` so the constrained-decoding FSM
(engine/constrain/) can walk token strings without tokenizer-specific code.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

from .. import telemetry


def _gpt2_byte_decoder() -> Dict[str, int]:
    """Inverse of the GPT-2 byte-level BPE unicode mapping: printable stand-in
    char -> original byte. Covers Qwen/Llama/gpt-oss vocabs."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(0xA1, 0xAC + 1))
        + list(range(0xAE, 0xFF + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {chr(c): b for b, c in zip(bs, cs)}


_GPT2_BYTE_DECODER = _gpt2_byte_decoder()


class BaseTokenizer:
    vocab_size: int
    eos_id: int
    pad_id: int
    bos_id: Optional[int] = None

    def encode(self, text: str) -> List[int]:
        raise NotImplementedError

    def encode_batch(self, texts: Sequence[str]) -> List[List[int]]:
        """Encode many texts in one call. Subclasses with a native
        batched path (HF's rust ``encode_batch``) override; the default
        loops — still one call site, so the engine never hand-rolls the
        per-row loop again."""
        return [self.encode(t) for t in texts]

    def concat_safe(self, left: str) -> bool:
        """True when ``encode(left + right) == encode(left) +
        encode(right)`` for EVERY right — i.e. no token can span the
        boundary after ``left``. Enables the shared-shell tokenization
        fast path (encode the chat-template shell once, per-row
        suffixes in batch). Default False: BPE merges can cross any
        boundary, so only tokenizers that can prove safety opt in."""
        return False

    def decode(self, ids: Sequence[int]) -> str:
        raise NotImplementedError

    def token_bytes(self, token_id: int) -> bytes:
        """Raw bytes this token contributes to the output stream (empty for
        special/control tokens)."""
        raise NotImplementedError

    def count(self, text: str) -> int:
        return len(self.encode(text))

    # -- chat templating ----------------------------------------------------
    def render_chat(
        self,
        user: str,
        system: Optional[str] = None,
        template: str = "chatml",
        add_generation_prompt: bool = True,
    ) -> str:
        """Render a single-turn prompt. ``chatml`` covers the Qwen/gpt-oss
        style; ``plain`` concatenates (tiny-model/tests); ``gemma``/``llama3``
        cover those families."""
        if template == "plain":
            return (system + "\n\n" if system else "") + user
        if template == "gemma":
            sys_part = (system + "\n\n") if system else ""
            out = f"<start_of_turn>user\n{sys_part}{user}<end_of_turn>\n"
            if add_generation_prompt:
                out += "<start_of_turn>model\n"
            return out
        if template == "llama3":
            out = "<|begin_of_text|>"
            if system:
                out += (
                    "<|start_header_id|>system<|end_header_id|>\n\n"
                    f"{system}<|eot_id|>"
                )
            out += (
                "<|start_header_id|>user<|end_header_id|>\n\n"
                f"{user}<|eot_id|>"
            )
            if add_generation_prompt:
                out += "<|start_header_id|>assistant<|end_header_id|>\n\n"
            return out
        # chatml (default)
        out = ""
        if system:
            out += f"<|im_start|>system\n{system}<|im_end|>\n"
        out += f"<|im_start|>user\n{user}<|im_end|>\n"
        if add_generation_prompt:
            out += "<|im_start|>assistant\n"
        return out

    def render_chat_continuation(
        self, user: str, template: str = "chatml"
    ) -> str:
        """Render the NEXT user turn of a running conversation — the
        text appended after an assistant reply whose terminal stop
        token was stripped from the stream (serving sessions store
        ``prompt_ids + token_ids``, which end mid-assistant-turn). The
        scaffold therefore re-supplies the assistant-end marker, then
        the user turn, then the generation prompt, so that
        ``stored_text + continuation`` is exactly the multi-turn render
        and the stored ids stay a strict prefix of the next prompt
        (the property session KV checkpointing rides on)."""
        if template == "plain":
            return "\n\n" + user
        if template == "gemma":
            return (
                "<end_of_turn>\n"
                f"<start_of_turn>user\n{user}<end_of_turn>\n"
                "<start_of_turn>model\n"
            )
        if template == "llama3":
            return (
                "<|eot_id|>"
                "<|start_header_id|>user<|end_header_id|>\n\n"
                f"{user}<|eot_id|>"
                "<|start_header_id|>assistant<|end_header_id|>\n\n"
            )
        # chatml (default)
        return (
            f"<|im_end|>\n<|im_start|>user\n{user}<|im_end|>\n"
            "<|im_start|>assistant\n"
        )


class ByteTokenizer(BaseTokenizer):
    """Byte-level tokenizer: ids 0..255 are raw bytes; specials follow.

    Special strings are tokenized atomically so chat templates round-trip.
    """

    SPECIALS = [
        "<pad>",
        "<eos>",
        "<bos>",
        "<|im_start|>",
        "<|im_end|>",
        "<start_of_turn>",
        "<end_of_turn>",
        "<|eot_id|>",
        "<|begin_of_text|>",
        "<|start_header_id|>",
        "<|end_header_id|>",
    ]

    def __init__(self, vocab_size: Optional[int] = None):
        self._special_to_id: Dict[str, int] = {
            s: 256 + i for i, s in enumerate(self.SPECIALS)
        }
        self.vocab_size = vocab_size or (256 + len(self.SPECIALS))
        if self.vocab_size < 256 + len(self.SPECIALS):
            raise ValueError("vocab_size too small for byte tokenizer")
        self.pad_id = self._special_to_id["<pad>"]
        self.eos_id = self._special_to_id["<eos>"]
        self.bos_id = self._special_to_id["<bos>"]
        self.im_end_id = self._special_to_id["<|im_end|>"]

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        i = 0
        while i < len(text):
            matched = False
            if text[i] == "<":
                for s, sid in self._special_to_id.items():
                    if text.startswith(s, i):
                        ids.append(sid)
                        i += len(s)
                        matched = True
                        break
            if not matched:
                ids.extend(text[i].encode("utf-8"))
                i += 1
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        out = bytearray()
        for t in ids:
            t = int(t)
            if t < 256:
                out.append(t)
        return out.decode("utf-8", errors="replace")

    def token_bytes(self, token_id: int) -> bytes:
        token_id = int(token_id)
        if token_id < 256:
            return bytes([token_id])
        return b""

    def concat_safe(self, left: str) -> bool:
        """The byte encoder scans left-to-right with no cross-char
        state, so the ONLY way a boundary changes tokenization is a
        special token starting inside ``left`` and ending after it.
        Safe iff ``left`` does not end with a proper prefix of any
        special."""
        for s in self._special_to_id:
            for k in range(1, len(s)):
                if left.endswith(s[:k]):
                    return False
        return True

    def stop_ids(self) -> List[int]:
        return [self.eos_id, self.im_end_id]


class HFTokenizer(BaseTokenizer):
    """Wraps a local HuggingFace ``tokenizer.json`` (no network)."""

    def __init__(self, path: str):
        from tokenizers import Tokenizer as _Tok

        if os.path.isdir(path):
            path = os.path.join(path, "tokenizer.json")
        self._tok = _Tok.from_file(path)
        self.vocab_size = self._tok.get_vocab_size()
        self._vocab = self._tok.get_vocab()
        self._token_bytes_cache: Dict[int, bytes] = {}
        # Byte-level BPE detection: every char of a known word-ish token maps
        # through the GPT-2 byte decoder.
        probe = self._tok.id_to_token(min(1000, self.vocab_size - 1)) or ""
        self._byte_level = bool(probe) and all(
            c in _GPT2_BYTE_DECODER for c in probe
        )
        ids = {}
        for cand in ["<|im_end|>", "<|endoftext|>", "</s>", "<eos>", "<end_of_turn>", "<|eot_id|>", "<|return|>"]:
            if cand in self._vocab:
                ids[cand] = self._vocab[cand]
        # eos preference order per family
        self.eos_id = next(iter(ids.values())) if ids else self.vocab_size - 1
        self._stop = list(dict.fromkeys(ids.values()))
        self.pad_id = self._vocab.get("<|endoftext|>", self.eos_id)
        self.bos_id = self._vocab.get("<|begin_of_text|>", self._vocab.get("<bos>"))

    def encode(self, text: str) -> List[int]:
        return self._tok.encode(text, add_special_tokens=False).ids

    def encode_batch(self, texts: Sequence[str]) -> List[List[int]]:
        """Rust-side batched encode: releases the GIL and parallelizes
        internally — the per-row Python call overhead (the dominant host
        cost of tokenizing a 20k-row job) disappears."""
        if not texts:
            return []
        encs = self._tok.encode_batch(
            list(texts), add_special_tokens=False
        )
        return [e.ids for e in encs]

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(list(map(int, ids)), skip_special_tokens=True)

    def token_bytes(self, token_id: int) -> bytes:
        """Raw bytes of the token piece. Handles GPT-2 byte-level vocabs
        (per-char byte decoder — a lone token of a multi-byte UTF-8 char
        yields its true bytes, not U+FFFD) and SentencePiece vocabs
        ('▁' = space, '<0xNN>' byte tokens). Specials yield b""."""
        token_id = int(token_id)
        cached = self._token_bytes_cache.get(token_id)
        if cached is not None:
            return cached
        piece = self._tok.id_to_token(token_id)
        if piece is None:
            out = b""
        elif piece.startswith("<") and piece.endswith(">"):
            if len(piece) == 6 and piece[1:3].lower() == "0x":
                try:
                    out = bytes([int(piece[1:5], 16)])
                except ValueError:
                    out = b""
            else:
                out = b""  # special/control token
        elif self._byte_level:
            try:
                out = bytes(_GPT2_BYTE_DECODER[c] for c in piece)
            except KeyError:
                out = piece.encode("utf-8")
        else:
            out = piece.replace("▁", " ").encode("utf-8")
        self._token_bytes_cache[token_id] = out
        return out

    def stop_ids(self) -> List[int]:
        return self._stop or [self.eos_id]


def render_shell(
    tok: BaseTokenizer,
    system: Optional[str],
    template: str,
) -> Tuple[str, str]:
    """Split the chat template into the (prefix, suffix) shell around
    the user row: every row's prompt is ``pre + row + post``. Templates
    embed the user text verbatim (pure concatenation), so rendering via
    the shell is string-identical to per-row ``render_chat``."""
    mark = "\x00\x01sutro-row\x01\x00"
    shell = tok.render_chat(mark, system=system, template=template)
    pre, sep, post = shell.partition(mark)
    if not sep:  # a template that transforms user text: no shell
        return "", ""
    return pre, post


def encode_chat_batch(
    tok: BaseTokenizer,
    rows: Sequence[str],
    system: Optional[str],
    template: str,
    threads: int = 0,
) -> List[List[int]]:
    """Tokenize every row's full chat prompt in one batched pass.

    Prefix-aware: when the tokenizer proves the shell boundary is
    concat-safe (ByteTokenizer), the shared shell prefix — chat
    scaffold plus the whole system prompt — is encoded ONCE and each
    row encodes only ``row + suffix``; a 20k-row job stops re-encoding
    20k copies of its system prompt. Unsafe tokenizers (BPE merges span
    boundaries) encode full prompts through ``encode_batch``, which is
    the rust-parallel path for HF vocabs. Either way the ids are
    bit-identical to per-row ``encode(render_chat(row))`` — verified on
    the first row, with a full-prompt fallback if the proof ever fails.

    ``threads`` > 1 splits the batch across a thread pool — only useful
    for tokenizers whose ``encode_batch`` releases the GIL.
    """
    rows = list(rows)
    if not rows:
        return []
    if telemetry.ENABLED:
        # batch-granular (never per row): row volume through the batched
        # tokenize path, plus its latency histogram below
        telemetry.TOKENIZE_ROWS_TOTAL.inc(float(len(rows)))
        t0 = time.monotonic()
        try:
            return _encode_chat_batch(tok, rows, system, template, threads)
        finally:
            telemetry.stage_observe(
                "tokenize", time.monotonic() - t0
            )
    return _encode_chat_batch(tok, rows, system, template, threads)


def _encode_chat_batch(
    tok: BaseTokenizer,
    rows: List[str],
    system: Optional[str],
    template: str,
    threads: int = 0,
) -> List[List[int]]:
    def _batched(texts: List[str]) -> List[List[int]]:
        if threads > 1 and len(texts) >= 2 * threads:
            from concurrent.futures import ThreadPoolExecutor

            step = (len(texts) + threads - 1) // threads
            chunks = [
                texts[o : o + step] for o in range(0, len(texts), step)
            ]
            with ThreadPoolExecutor(max_workers=threads) as ex:
                parts = list(ex.map(tok.encode_batch, chunks))
            return [ids for part in parts for ids in part]
        return tok.encode_batch(texts)

    pre, post = render_shell(tok, system, template)
    if not pre and not post:
        # no recoverable shell: render per row (templates that
        # transform user text), still one batched encode
        return _batched(
            [
                tok.render_chat(r, system=system, template=template)
                for r in rows
            ]
        )
    if pre and tok.concat_safe(pre):
        head = tok.encode(pre)
        out = [head + ids for ids in _batched([r + post for r in rows])]
        # boundary proof spot-check: one direct encode per job
        if out[0] != tok.encode(pre + rows[0] + post):
            out = _batched([pre + r + post for r in rows])
        return out
    return _batched([pre + r + post for r in rows])


def load_tokenizer(
    weights_dir: Optional[str], vocab_size: Optional[int] = None
) -> BaseTokenizer:
    """HF tokenizer if a checkpoint dir with tokenizer.json exists, else the
    byte tokenizer sized to the model's vocab."""
    if weights_dir:
        tj = os.path.join(weights_dir, "tokenizer.json")
        if os.path.exists(tj):
            return HFTokenizer(tj)
    return ByteTokenizer(vocab_size=vocab_size)
