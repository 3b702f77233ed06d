"""What decides ``correct``: the served tokens held against the plain
reference, and the bill held against the rows.

- ``logit_gap``: for a sample of finished greedy rows, the reference
  runs once over each prompt (tokenized by the reference's own chat
  template) followed by the row's served tokens; at each served
  position, the gap by which the served token's logit lies below the
  reference's best. The reading is the widest gap over the sample (the
  mean gap, ``mean_logit_gap``, is printed beside it). A cell's limits
  file says which it compares.
- ``billed_mismatch``: jobs whose last progress record's
  ``input_tokens + output_tokens`` differ from the harness's own sum
  over the returned rows (reference prompt tokens plus each row's
  ``gen_tokens``). The limit is 0.
- ``failed_rows``: rows that came back with an error. The limit is 0.

The control (``int4`` or ``fp8``: the reference one precision below the
configuration's, put in the program's place) reads, at the same
positions, the gap of the token that the lower precision puts first.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from .reference import chat, qwen3
from .weights import PRINTABLE



def served_ids(text: Optional[str], gen_tokens: int) -> Optional[List[int]]:
    """A row's served token ids, read back from its text: one printable
    ASCII character a token (see :mod:`portbench.weights`). None when
    the text does not account for every token served."""
    if text is None:
        return None
    ids = [ord(c) for c in text]
    if len(ids) != gen_tokens or any(i not in PRINTABLE for i in ids):
        return None
    return ids


def gaps(cfg: Dict, weights, rows: Sequence[Dict], control: Optional[str] = None
         ) -> Dict[str, Dict[str, float]]:
    """Logit gaps over ``rows`` (each ``{"prompt": ids, "served": ids}``):
    for ``served`` and for the ``control`` precision when given, the widest
    gap over every served position (``max``) and their mean (``mean``)."""
    m = cfg["model"]
    wq = cfg["engine"].get("quantize") or ""
    dev = weights.device
    seqs = [torch.tensor(r["prompt"] + r["served"], device=dev) for r in rows]
    start = [len(r["prompt"]) - 1 for r in rows]
    firsts: List[List[torch.Tensor]] = [[] for _ in rows]
    if control:
        def keep(s, a, logits):
            firsts[s].append(logits.argmax(-1))
        qwen3.forward(m, weights, seqs, start, qwen3.Precision(control, wq), keep)
    ctrl_pos = [torch.cat(f) if f else None for f in firsts]
    seen: Dict[str, List[torch.Tensor]] = {"served": [], **({control: []} if control else {})}

    def read(s, a, logits):
        n_served = len(rows[s]["served"])
        j0, j1 = a - start[s], min(a - start[s] + logits.shape[0], n_served)
        if j1 <= j0:
            return
        lg = logits[: j1 - j0]
        best = lg.max(-1).values
        served = torch.tensor(rows[s]["served"][j0:j1], device=lg.device)
        seen["served"].append(best - lg.gather(1, served[:, None])[:, 0])
        if control:
            tok = ctrl_pos[s][j0:j1]
            seen[control].append(best - lg.gather(1, tok[:, None])[:, 0])

    qwen3.forward(m, weights, seqs, start, qwen3.Precision("served", wq), read)
    out = {}
    for k, parts in seen.items():
        g = torch.cat(parts) if parts else torch.zeros(0)
        n = max(g.numel(), 1)
        out[k] = {"max": g.max().item() if g.numel() else 0.0, "mean": g.sum().item() / n}
    return out


def billed(prompt_tokens: Sequence[int], gen_tokens: Sequence[int]) -> int:
    return int(sum(prompt_tokens) + sum(gen_tokens))


def prompt_tokens(cfg: Dict, inputs: Sequence[str], system: Optional[str]) -> List[List[int]]:
    return [chat.prompt_ids(x, system, cfg["chat_template"]) for x in inputs]
