"""The KV page write's share of its roofline (``ops/kv_write.py``,
``csrc/kv_write.cu``): every new token's K and V read and written into
the pool, in decode and prefill."""

from portbench import work


def read(run):
    return work.roofline(run, work.kv_write, lambda n: "kv_write" in n)
