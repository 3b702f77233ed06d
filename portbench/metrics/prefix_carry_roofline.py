"""The prefix-carry kernel's share of its roofline (``ops/prefix_carry.py``,
``csrc/prefix_carry.cu``): each group's shared prefix read once a
layer-step for all its member rows."""

from portbench import work


def read(run):
    if not work.has_groups(run):
        return None
    return work.roofline(run, work.prefix_carry, lambda n: "prefix_carry" in n)
