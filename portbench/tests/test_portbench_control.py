"""The check's control at the program's tiny sizes: the reference put in
the program's place one precision below what the configuration states
(fp8 for bf16, int4 for int8 weights) reads a logit gap far above the
program's and above the limit, so the check fails it: tiny-moe against
fp8, and tiny-moe with int8 weights against int4 (tiny-dense's tied,
head-scaled embedding dominates its two layers' residual, so no rounding
moves its choices). The int8 cell quantizes weights only: the reference
keeps no KV cache, so int8 KV pages' rounding is held against the limit
at the cell's own size on the card, not here."""

import json
import re

import pytest

from portbench import harness
from portbench.tests import tiny


@pytest.fixture
def root(tmp_path, monkeypatch):
    monkeypatch.setenv("SUTRO_MONITOR", "0")
    root = tiny.make_root(tmp_path)
    cfg = tiny.config("tiny-moe", quantize="int8")
    (root / "portbench" / "configs" / "int8.json").write_text(json.dumps(cfg))
    (root / "portbench" / "limits" / "int8.mix.json").write_text(
        json.dumps({"logit_gap": tiny.LIMIT}))
    doc = json.loads((root / "BENCHMARK.json").read_text())
    doc["configs"].append({"name": "int8", "source": "x", "file": "portbench/configs/int8.json",
                           "reduced": [], "why": "x"})
    doc["workloads"].append({"name": "int8.mix", "config": "int8", "traffic": "mix",
                             "chips": 1, "why": "x"})
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    return root


@pytest.mark.parametrize("cell,control", [("tiny-moe.mix", "fp8"), ("int8.mix", "int4")])
@pytest.mark.parametrize("seed", [11, 2**31 + 3, 424242])
def test_the_control_fails_the_check(root, capsys, cell, control, seed):
    assert harness.run(cell, seed, 1.5, False, root=root, device="cpu", control=control) == 0
    out = capsys.readouterr()
    res = tiny.last_json(out.out)
    ctrl = res["checks"]["logit_gap"]["value"]
    program = float(re.search(r"program \(not judged in a control run\): logit_gap (\S+)",
                              out.err).group(1))
    assert res["correct"] is False and ctrl > tiny.LIMIT
    assert program <= tiny.LIMIT and ctrl >= 3 * max(program, 1e-3)
