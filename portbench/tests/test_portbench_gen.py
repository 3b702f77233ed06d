"""The ``jobs`` generator: deterministic by seed, sizes within each mix's
ranges and the same for every seed, job shapes as the mixes state."""

import json
from pathlib import Path

import pytest

from portbench.gen import jobs
from portbench.reference import chat

TRAFFIC = Path(__file__).resolve().parent.parent / "traffic"
MIXES = sorted(p.stem for p in TRAFFIC.glob("*.json"))
BIG_SEED = 2**31 + 12345


def mix(name):
    return json.loads((TRAFFIC / f"{name}.json").read_text())


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_jobs(name):
    a, b = jobs.make(mix(name), BIG_SEED, "m"), jobs.make(mix(name), BIG_SEED, "m")
    for k in range(3):
        assert a.job(k) == b.job(k)


@pytest.mark.parametrize("name", MIXES)
def test_other_seed_other_text_same_sizes(name):
    m = mix(name)
    a, b = jobs.make(m, 1, "m"), jobs.make(m, BIG_SEED, "m")
    for k in range(4):
        ja, jb = a.job(k), b.job(k)
        assert ja["inputs"] != jb["inputs"]
        assert sorted(map(len, ja["inputs"])) == sorted(map(len, jb["inputs"]))
        assert ja["sampling_params"] == jb["sampling_params"]


@pytest.mark.parametrize("name", MIXES)
def test_lengths_within_the_mix(name):
    m = mix(name)
    g = jobs.make(m, 7, "m")
    lo, hi = m["prompt_tokens"]
    nlo, nhi = m["max_new_tokens"]
    caps = set()
    for k in range(40):
        j = g.job(k)
        assert len(j["inputs"]) == m["rows_per_job"]
        for text in j["inputs"]:
            # one token a byte, no special token's string inside
            assert lo <= len(chat.encode(text)) == len(text) <= hi
            assert "<" not in text
        sp = j["system_prompt"]
        assert (len(sp) if sp else 0) == m["system_prompt_tokens"]
        n = j["sampling_params"]["max_new_tokens"]
        assert nlo <= n <= nhi
        caps.add(n)
        greedy = j["sampling_params"]["temperature"] == 0.0
        assert greedy == g.greedy(k)
    # the caps spread over the range, low and high ends both reached
    assert min(caps) < nlo * (nhi / nlo) ** 0.2 and max(caps) > nlo * (nhi / nlo) ** 0.8


def test_generate_mix_mixes_greedy_jobs_in():
    g = jobs.make(mix("generate"), 3, "m")
    greedy = [k for k in range(16) if g.greedy(k)]
    assert greedy == [0, 4, 8, 12]
    # the first job, the check's, has the lowest cap
    assert g.job(0)["sampling_params"]["max_new_tokens"] == mix("generate")["max_new_tokens"][0]
