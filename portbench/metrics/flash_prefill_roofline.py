"""The flash prefill kernel's share of its roofline (``ops/flash_prefill.py``,
``csrc/flash_prefill.cu``): causal attention over prompts with no past."""

from portbench import work


def read(run):
    return work.roofline(run, work.flash_prefill, lambda n: "flash_prefill" in n)
