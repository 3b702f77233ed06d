"""The paged decode kernel's share of its roofline on int8 pages with
their per-token scales (``ops/paged_decode.py``, its int8 option)."""

from portbench import work


def read(run):
    if not run.model.kv_int8:
        return None
    return work.roofline(run, work.paged_decode, lambda n: "paged_decode" in n)
