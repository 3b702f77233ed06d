"""The yardstick's arithmetic against the bounds of the kernel table in
PERF.md (chip_smoke.py's shapes), and the active parameters of an MoE
model."""

import json
from pathlib import Path

import pytest

from portbench import yardstick as ys

CONFIGS = Path(__file__).resolve().parent.parent / "configs"
PEAK = ys.PEAKS["h100"]


def model(**kw):
    base = dict(H=4096, L=36, NH=32, KVH=8, Dh=128, V=151936, F=12288, E=0, K=0, Fm=0,
                w_int8=False, kv_int8=False)
    base.update(kw)
    return ys.Model(**base)


def bound_ms(flops, nbytes):
    return 1e3 * max(nbytes / PEAK[0], flops / PEAK[1])


def test_flash_prefill_bound_8x500():
    # PERF.md kernel table row 3: 8 x 500 at qwen3-8b, bound 0.0245 ms (bytes)
    f, b = ys.flash_prefill(model(), [500] * 8)
    assert round(bound_ms(f, b), 4) == 0.0245


@pytest.mark.parametrize("M,experts,want", [
    (512, 127, 0.1201),      # a decode step, ~127 experts
    (512, 21, 0.0206),       # a random-weight decode step
])
def test_grouped_matmul_bound_qwen3_30b(M, experts, want):
    f, b = ys.grouped_matmul(M, 2048, 768, experts)
    assert round(bound_ms(f, b), 4) == want


@pytest.mark.parametrize("M,experts,want", [(256, 31, 0.1544), (16000, 32, 0.2684)])
def test_grouped_matmul_bound_gpt_oss(M, experts, want):
    f, b = ys.grouped_matmul(M, 2880, 2880, experts)
    assert round(bound_ms(f, b), 4) == want


def test_prefix_carry_bound_within_a_tenth():
    # row 4: a 1,024-token template, KVH 4, 56 member rows: 0.0011 ms
    m = model(H=2048, NH=32, KVH=4)
    f, b = ys.prefix_carry(m, 1024, 56)
    assert abs(bound_ms(f, b) - 0.0011) / 0.0011 < 0.1


def test_moe_flops_count_active_parameters():
    cfg = json.loads((CONFIGS / "qwen3-30b-a3b.json").read_text())
    m = ys.Model.of(cfg)
    active = m.token_flops(0, logits=True) / 2
    # about 3.3B active of 30.5B, the embedding's 0.31B not multiplied
    assert 2.9e9 < active < 3.4e9
    dense = json.loads((CONFIGS / "qwen3-32b-int8.json").read_text())
    assert 31e9 < ys.Model.of(dense).token_flops(0, logits=True) / 2 < 33e9


def test_attention_flops_grow_with_context():
    m = model()
    assert m.token_flops(1000, False) - m.token_flops(0, False) == m.L * 4 * m.NH * m.Dh * 1000


def test_decode_step_bytes_read_only_routed_experts():
    cfg = json.loads((CONFIGS / "qwen3-30b-a3b.json").read_text())
    m = ys.Model.of(cfg)
    full = m.decode_step_bytes([0])
    few = m.decode_step_bytes([0], experts=[8] * m.L)
    # all 128 experts of 48 layers are ~58 GB of bf16; 8 a layer ~3.6 GB,
    # beside 1.8 GB of attention and 0.6 GB of output head
    assert 55e9 < full < 62e9 and 5.5e9 < few < 6.5e9


def test_int8_weights_count_bytes_at_rest():
    cfg = json.loads((CONFIGS / "qwen3-32b-int8.json").read_text())
    m = ys.Model.of(cfg)
    # 33.6 GB of int8 weights and scales a step, plus one token's KV write
    assert 32e9 < m.decode_step_bytes([0]) < 35e9


def test_share_is_none_without_time_or_work():
    assert ys.share(1.0, 1.0, 0.0, PEAK) is None
    assert ys.share(0.0, 0.0, 1.0, PEAK) is None
    assert ys.share(0.0, PEAK[0], 2.0, PEAK) == pytest.approx(50.0)
