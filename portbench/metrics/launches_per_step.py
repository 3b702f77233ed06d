"""Device kernels launched a decode step (``engine/runner.py``): kernels in
the window's trace over the window's decode steps."""

from portbench.trace import is_kernel


def read(run):
    steps = run.decode_steps()
    if not run.ops or not steps:
        return None
    return sum(1 for n, _, _ in run.ops if is_kernel(n)) / steps
