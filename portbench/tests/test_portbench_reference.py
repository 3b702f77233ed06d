"""The frozen reference against the port's own forward at the program's
tiny sizes on the CPU: the same seeded weights through the port's
checkpoint loader and through the reference, prefill logits and a greedy
decode step through the paged cache."""

import numpy as np
import pytest
import torch

from portbench import program
from portbench.reference import chat, qwen3
from portbench.tests import tiny
from portbench.weights import SeededWeights

SEED = 2**31 + 5


def port_runner(key, tmp_path, monkeypatch, **engine):
    from sutro_tpu_torch.engine.config import EngineConfig
    from sutro_tpu_torch.engine.runner import ModelRunner
    from sutro_tpu_torch.models.configs import MODEL_CONFIGS
    import sutro_tpu_torch.engine.weights as wmod

    cfg = tiny.config(key, **engine)
    w = SeededWeights(cfg["model"], SEED, device="cpu")
    monkeypatch.setattr(wmod, "_ShardIndex", wmod._ShardIndex)   # restored after the test
    program.install_weights(w)
    ecfg = EngineConfig(**dict(cfg["engine"], param_dtype="float32",
                               activation_dtype="float32"))
    return cfg, w, ModelRunner(MODEL_CONFIGS[key], ecfg, device="cpu", checkpoint=str(tmp_path))


def reference_logits(cfg, w, ids):
    out = {}
    prec = qwen3.Precision("served", cfg["engine"].get("quantize") or "")
    qwen3.forward(cfg["model"], w, [torch.tensor(ids)], [0], prec,
                  lambda s, a, lg: out.setdefault("l", []).append(lg))
    return torch.cat(out["l"])


@pytest.mark.parametrize("key,engine", [
    ("tiny-dense", {}),
    ("tiny-moe", {}),
    ("tiny-moe", {"quantize": "int8"}),
    ("tiny-dense", {"quantize": "int8"}),
], ids=["dense", "moe", "moe-int8", "dense-int8"])
def test_prefill_and_decode_match_the_reference(key, engine, tmp_path, monkeypatch):
    cfg, w, runner = port_runner(key, tmp_path, monkeypatch, **engine)
    ids = chat.prompt_ids("a row of plain text, tokenized as bytes", "a system prompt", "plain")
    n = len(ids)
    table = np.arange(1, 1 + cfg["engine"]["max_pages_per_seq"], dtype=np.int32)
    got = torch.as_tensor(runner.prefill(np.asarray(ids, np.int32), table))
    ref = reference_logits(cfg, w, ids)
    want = ref[n - 1]
    assert (got - want).abs().max() <= 2e-4 * want.abs().max()
    # one greedy step through the paged cache
    tok = int(want.argmax())
    nxt, logp = runner.decode_step(np.array([tok], np.int32), np.array([n], np.int32),
                                   table[None], 0, np.zeros(1, np.float32),
                                   np.ones(1, np.float32))
    step = reference_logits(cfg, w, ids + [tok])[n]
    assert int(nxt[0]) == int(step.argmax())
    assert float(logp[0]) == pytest.approx(float(torch.log_softmax(step, -1).max()), abs=1e-3)


def test_the_reference_is_causal_and_reads_its_norms():
    cfg = tiny.config("tiny-moe")
    w = SeededWeights(cfg["model"], SEED, device="cpu")
    a = reference_logits(cfg, w, [5, 6, 7, 8])
    b = reference_logits(cfg, w, [5, 6, 7, 9])
    assert torch.allclose(a[:3], b[:3], atol=1e-5) and (a[3] - b[3]).abs().max() > 1e-3
    norm = w.layer(0)["input_layernorm.weight"]
    assert (norm - 1).abs().max() > 0.01   # drawn, not all ones
