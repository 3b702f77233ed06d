"""A benchmark of its own at the program's tiny sizes, for CPU tests: a
copy of ``portbench/`` beside a ``BENCHMARK.json`` whose cells run the
``tiny-dense`` and ``tiny-moe`` models of ``sutro_tpu_torch``."""

import json
import shutil
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent

ENGINE = {"kv_page_size": 8, "max_pages_per_seq": 16, "decode_batch_size": 4,
          "max_model_len": 128, "decode_multi_step": 4, "max_batch_tokens": 512,
          "prefill_chunk": 32}
COMMON = {"hidden_size": 128, "intermediate_size": 256, "num_hidden_layers": 2,
          "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 32,
          "vocab_size": 512, "rms_norm_eps": 1e-06, "rope_theta": 1000000}
MODELS = {
    "tiny-dense": dict(COMMON, tie_word_embeddings=True),
    "tiny-moe": dict(COMMON, tie_word_embeddings=False, moe_intermediate_size=128,
                     num_experts=4, num_experts_per_tok=2, norm_topk_prob=True),
}
MIX = {"kind": "jobs", "rows_per_job": 2, "prompt_tokens": [8, 40], "system_prompt_tokens": 0,
       "max_new_tokens": [8, 16], "temperature": 0.7, "top_p": 0.95, "greedy_every": 2,
       "greedy_offset": 0, "queued_jobs": 2, "check_rows": 4}
LIMIT = 0.1


# tiny-moe runs in float32: with 4 experts, top 2, a bf16 rounding that
# flips one routing choice moves a logit by several units, as no
# full-size model's does; in float32 the program and the reference agree
# to rounding, so the fault tests see only the faults
PRECISION = {"tiny-dense": {}, "tiny-moe": {"param_dtype": "float32",
                                            "activation_dtype": "float32"}}


def config(key, **engine):
    return {"source": "sutro_tpu_torch/models/configs.py", "model": MODELS[key],
            "engine_key": key, "chat_template": "plain",
            "engine": dict(ENGINE, **PRECISION[key], **engine),
            "reduced": [], "assumed": []}


def make_root(tmp: Path) -> Path:
    """A benchmark root with cells ``tiny-dense.mix`` and ``tiny-moe.mix``."""
    root = tmp / "bench"
    shutil.copytree(PKG, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    doc = {"command": ["python3", "-m", "portbench.run"], "paths": ["portbench"],
           "run_seconds": 2, "configs": [], "workloads": [],
           "end_to_end": [
               {"name": "tok_s", "unit": "tokens/s", "better": "higher", "bound": 0.25,
                "source": "host_clock"},
               {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
                "source": "host_clock"}],
           "per_layer": [
               {"name": "rows_per_step", "unit": "rows", "better": "higher",
                "source": "program_span", "layer": "scheduler", "moves": "tok_s"},
               {"name": "submit_ms", "unit": "ms", "better": "lower",
                "source": "program_span", "layer": "facade", "moves": "tok_s"}]}
    (root / "portbench" / "traffic" / "mix.json").write_text(json.dumps(MIX))
    for key in MODELS:
        f = f"portbench/configs/{key}.json"
        (root / f).write_text(json.dumps(config(key)))
        doc["configs"].append({"name": key, "source": "x", "file": f, "reduced": [], "why": "x"})
        doc["workloads"].append({"name": f"{key}.mix", "config": key, "traffic": "mix",
                                 "chips": 1, "why": "x"})
        (root / "portbench" / "limits" / f"{key}.mix.json").write_text(
            json.dumps({"logit_gap": LIMIT}))
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    return root


def last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])
