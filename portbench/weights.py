"""Random weights of one configuration, drawn on the device from a seed.

Every tensor has its Hugging Face checkpoint name and layout
(``model.layers.{i}.self_attn.q_proj.weight`` as ``[out, in]``), so the
program reads them through its checkpoint loader, as it would a real
checkpoint, and the plain reference draws the same tensors again layer
by layer. A tensor's values depend only on the seed and its name: each
draw seeds a generator of its own from both, so any one layer can be
drawn again without the others.

Widths follow the configuration. Values:

- projections and the router: normal, scaled by ``in ** -0.5``;
- norm weights: ``1 + 0.1 * normal`` (a unit weight would hide a norm
  that is left out);
- the output head (or the tied embedding): normal, scaled by ``in ** -0.5``,
  and by ``HEAD_LIVE`` on the printable ASCII rows and ``HEAD_DEAD`` on
  all others. The byte tokenizer turns printable ASCII ids back into
  their characters one for one and drops every other id from the text,
  so the served tokens can be read back from a row's output: a row ends
  only at its ``max_new_tokens``, and its output text is its tokens.

One configuration's experts are drawn as one block a layer and
projection (``[E, out, in]``) and handed out one expert at a time.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Iterator, Tuple

import torch

PRINTABLE = range(32, 127)
HEAD_LIVE = 8.0
HEAD_DEAD = 0.01


def head_scale(vocab: int, device) -> torch.Tensor:
    """Per-row scale of the output head: ``HEAD_LIVE`` on printable
    ASCII ids, ``HEAD_DEAD`` elsewhere."""
    s = torch.full((vocab,), HEAD_DEAD, dtype=torch.float32, device=device)
    s[PRINTABLE.start : PRINTABLE.stop] = HEAD_LIVE
    return s


def _stream_seed(seed: int, name: str) -> int:
    digest = hashlib.sha256(f"{int(seed)}/{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


class SeededWeights:
    """The tensors of ``model`` (a Hugging Face ``config.json`` dict),
    drawn in ``dtype`` on ``device`` from ``seed``."""

    def __init__(self, model: Dict, seed: int, device="cuda", dtype=torch.bfloat16):
        self.m = model
        self.seed = int(seed)
        self.device = torch.device(device)
        self.dtype = dtype
        self._block: Tuple[str, torch.Tensor] = ("", None)
        self.shapes = dict(self._shapes())

    # -- layout -----------------------------------------------------------

    def _shapes(self) -> Iterator[Tuple[str, tuple]]:
        m = self.m
        H, V = m["hidden_size"], m["vocab_size"]
        Dh = m.get("head_dim") or H // m["num_attention_heads"]
        NHD, KVD = m["num_attention_heads"] * Dh, m["num_key_value_heads"] * Dh
        yield "model.embed_tokens.weight", (V, H)
        yield "model.norm.weight", (H,)
        if not m.get("tie_word_embeddings", False):
            yield "lm_head.weight", (V, H)
        for i in range(m["num_hidden_layers"]):
            p = f"model.layers.{i}."
            yield p + "input_layernorm.weight", (H,)
            yield p + "post_attention_layernorm.weight", (H,)
            yield p + "self_attn.q_proj.weight", (NHD, H)
            yield p + "self_attn.k_proj.weight", (KVD, H)
            yield p + "self_attn.v_proj.weight", (KVD, H)
            yield p + "self_attn.o_proj.weight", (H, NHD)
            yield p + "self_attn.q_norm.weight", (Dh,)
            yield p + "self_attn.k_norm.weight", (Dh,)
            if m.get("num_experts"):
                E, F = m["num_experts"], m["moe_intermediate_size"]
                yield p + "mlp.gate.weight", (E, H)
                for e in range(E):
                    yield p + f"mlp.experts.{e}.gate_proj.weight", (F, H)
                    yield p + f"mlp.experts.{e}.up_proj.weight", (F, H)
                    yield p + f"mlp.experts.{e}.down_proj.weight", (H, F)
            else:
                F = m["intermediate_size"]
                yield p + "mlp.gate_proj.weight", (F, H)
                yield p + "mlp.up_proj.weight", (F, H)
                yield p + "mlp.down_proj.weight", (H, F)

    # -- draws ------------------------------------------------------------

    def _normal(self, name: str, shape: tuple) -> torch.Tensor:
        g = torch.Generator(device=self.device)
        g.manual_seed(_stream_seed(self.seed, name))
        return torch.randn(shape, generator=g, device=self.device, dtype=self.dtype)

    def _draw(self, name: str, shape: tuple) -> torch.Tensor:
        if name.endswith("norm.weight"):
            return self._normal(name, shape).mul_(0.1).add_(1.0)
        w = self._normal(name, shape).mul_(shape[-1] ** -0.5)
        head = "lm_head.weight" if "lm_head.weight" in self.shapes else "model.embed_tokens.weight"
        if name == head:
            w.mul_(head_scale(shape[0], self.device).to(w.dtype)[:, None])
        return w

    def get(self, name: str) -> torch.Tensor:
        if ".experts." not in name:
            return self._draw(name, self.shapes[name])
        # model.layers.{i}.mlp.experts.{e}.{proj}.weight -> one block
        head, rest = name.split(".experts.")
        e, proj = rest.split(".", 1)
        key = f"{head}.experts.{proj}"
        if self._block[0] != key:
            self._block = ("", None)   # free the old block first
            E = self.m["num_experts"]
            self._block = (key, self._draw(key, (E, *self.shapes[name])))
        return self._block[1][int(e)]

    def release(self) -> None:
        """Drop the expert block kept for the loader."""
        self._block = ("", None)

    def layer(self, i: int) -> Dict[str, torch.Tensor]:
        """Layer ``i``'s tensors under their names less the
        ``model.layers.{i}.`` prefix; experts as ``[E, out, in]`` blocks
        (``mlp.experts.gate_proj`` ...)."""
        p = f"model.layers.{i}."
        out: Dict[str, torch.Tensor] = {}
        for name, shape in self.shapes.items():
            if not name.startswith(p):
                continue
            short = name[len(p):]
            if ".experts." in short:
                e, proj = short.split(".experts.")[1].split(".", 1)
                if e == "0":
                    key = f"{p}mlp.experts.{proj}"
                    out[f"mlp.experts.{proj}"] = self._draw(
                        key, (self.m["num_experts"], *shape))
                continue
            out[short] = self._draw(name, shape)
        return out


class SeededIndex:
    """The checkpoint reader's interface (``name in idx``, ``names()``,
    ``shape(name)``, ``get(name)``) over :class:`SeededWeights`: the
    program's loader maps these tensors into its own layout."""

    def __init__(self, weights: SeededWeights):
        self.w = weights

    def __contains__(self, name: str) -> bool:
        return name in self.w.shapes

    def names(self):
        return list(self.w.shapes)

    def shape(self, name: str) -> tuple:
        return tuple(self.w.shapes[name])

    def entry(self, name: str) -> Dict:
        return {"dtype": "BF16", "shape": list(self.w.shapes[name])}

    def get(self, name: str) -> torch.Tensor:
        return self.w.get(name)
