"""A decode step's share of the HBM roofline (the runner's decode step):
the bytes the window's decode steps need (every weight read once, an MoE
layer's routed experts only, and the KV read and written) over 3.35 TB/s
and the device seconds of the window's decode (the trace's busy time
outside the runner's prefill calls), in percent."""

from portbench import work


def read(run):
    seconds = run.decode_busy_s()
    if run.peaks is None or not run.decode_calls() or not seconds:
        return None
    return 100.0 * work.decode_bytes(run) / (run.peaks[0] * seconds)
