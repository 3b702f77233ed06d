"""The paged decode kernel's share of its roofline where rows start after a
shared prefix (``ops/paged_decode.py``, its carry option): each row's own
pages and window."""

from portbench import work


def read(run):
    if run.model.kv_int8 or not work.has_groups(run):
        return None
    return work.roofline(run, work.paged_decode, lambda n: "paged_decode" in n)
