"""Generator kind ``jobs``: a stream of batch jobs, as users submit them.

A mix file (``portbench/traffic/<mix>.json``) names this kind and sets:

- ``rows_per_job``: rows in each job;
- ``prompt_tokens`` ``[lo, hi]``: each row's text, in tokens (the byte
  tokenizer makes one token a byte), log-uniform over the range;
- ``system_prompt_tokens``: the job's own template, sent as its
  ``system_prompt`` (0: none);
- ``max_new_tokens`` ``[lo, hi]``: each job's cap, log-uniform;
- ``temperature``, ``top_p``: the sampled jobs' settings;
- ``greedy_every``, ``greedy_offset``: job ``k`` is greedy when ``k %
  greedy_every == greedy_offset`` (``greedy_every`` 1: every job);
- ``queued_jobs``: jobs kept waiting beyond what the decode slots hold;
- ``check_rows``: greedy rows the output check runs through the
  reference.

The sizes are the same for every seed: job ``k``'s cap and the set of its
rows' lengths come from a low-discrepancy sequence over the ranges, so
every run does the same work, in the same order. The seed draws the text, the order of the
lengths within each job and the sample of rows the check reads.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

# printable ASCII but '<', which could open a special token's string
ALPHABET = np.array([c for c in map(chr, range(32, 127)) if c != "<"])
_PHI = (math.sqrt(5.0) - 1.0) / 2.0


def _log_uniform(lo: int, hi: int, u: float) -> int:
    return int(round(lo * (hi / lo) ** u))


def _rng(seed: int, *keys: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & ((1 << 64) - 1), *keys])


class Jobs:
    def __init__(self, mix: Dict, seed: int, model: str):
        self.mix = mix
        self.seed = int(seed)
        self.model = model
        self.rows_per_job = int(mix["rows_per_job"])

    def greedy(self, k: int) -> bool:
        every = int(self.mix.get("greedy_every", 1))
        return every > 0 and k % every == int(self.mix.get("greedy_offset", 0)) % every

    def max_new_tokens(self, k: int) -> int:
        """The Weyl sequence ``k * phi`` over the range: job 0 gets the
        lowest cap, so the first job, admitted in set-up, ends early in a
        window."""
        lo, hi = self.mix["max_new_tokens"]
        return _log_uniform(lo, hi, (k * _PHI) % 1.0)

    def prompt_lengths(self, k: int) -> List[int]:
        """Row ``i`` of job ``k`` gets the ``i``-th of ``R`` strata of the
        range, shifted by job; the seed shuffles them over the rows."""
        lo, hi = self.mix["prompt_tokens"]
        R = self.rows_per_job
        shift = (0.5 + k * _PHI * _PHI) % 1.0
        lens = [_log_uniform(lo, hi, (i + shift) / R) for i in range(R)]
        order = _rng(self.seed, k, 1).permutation(R)
        return [lens[j] for j in order]

    def text(self, n: int, rng: np.random.Generator) -> str:
        return "".join(ALPHABET[rng.integers(0, len(ALPHABET), n)])

    def job(self, k: int) -> Dict:
        """The ``POST /batch-inference`` payload of job ``k``."""
        rng = _rng(self.seed, k, 2)
        n_sys = int(self.mix.get("system_prompt_tokens", 0))
        greedy = self.greedy(k)
        payload = {
            "model": self.model,
            "inputs": [self.text(n, rng) for n in self.prompt_lengths(k)],
            "system_prompt": self.text(n_sys, rng) if n_sys else None,
            "sampling_params": {
                "max_new_tokens": self.max_new_tokens(k),
                "temperature": 0.0 if greedy else float(self.mix["temperature"]),
                "top_p": 1.0 if greedy else float(self.mix["top_p"]),
            },
            "name": f"job-{k}",
        }
        return payload


make = Jobs
