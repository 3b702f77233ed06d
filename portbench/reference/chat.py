"""The prompt a row becomes: the chat template rendered around it, then
byte tokens (one id a UTF-8 byte, special strings one id each).

Written from the template's published form (ChatML for Qwen3) and the
byte tokenizer's id table, not taken from the program.
"""

from __future__ import annotations

from typing import List, Optional

SPECIALS = [
    "<pad>", "<eos>", "<bos>", "<|im_start|>", "<|im_end|>",
    "<start_of_turn>", "<end_of_turn>", "<|eot_id|>",
    "<|begin_of_text|>", "<|start_header_id|>", "<|end_header_id|>",
]
SPECIAL_IDS = {s: 256 + i for i, s in enumerate(SPECIALS)}


def render(user: str, system: Optional[str], template: str) -> str:
    if template == "plain":
        return (system + "\n\n" if system else "") + user
    if template != "chatml":
        raise ValueError(f"no reference for chat template {template!r}")
    out = f"<|im_start|>system\n{system}<|im_end|>\n" if system else ""
    return out + f"<|im_start|>user\n{user}<|im_end|>\n<|im_start|>assistant\n"


def encode(text: str) -> List[int]:
    ids: List[int] = []
    i = 0
    while i < len(text):
        if text[i] == "<":
            hit = next((s for s in SPECIALS if text.startswith(s, i)), None)
            if hit is not None:
                ids.append(SPECIAL_IDS[hit])
                i += len(hit)
                continue
        ids.extend(text[i].encode("utf-8"))
        i += 1
    return ids


def prompt_ids(user: str, system: Optional[str], template: str) -> List[int]:
    return encode(render(user, system, template))
