"""The paged decode kernel's share of its roofline (``ops/paged_decode.py``,
``csrc/paged_decode.cu``) on bf16 pages with no shared-prefix carry."""

from portbench import work


def read(run):
    if run.model.kv_int8 or work.has_groups(run):
        return None
    return work.roofline(run, work.paged_decode, lambda n: "paged_decode" in n)
