"""The grouped GEMM's share of its roofline (``ops/grouped_matmul.py``,
``csrc/grouped_matmul.cu``): each call's routed rows by the weights of the
experts it gave rows to, from the harness's record of the calls."""

from portbench import work


def read(run):
    if not run.gemm:
        return None
    return work.roofline(run, work.grouped_matmul, lambda n: "grouped_matmul" in n)
