"""Host milliseconds to enqueue a fused decode step (``engine/runner.py``,
the program's ``decode_window`` spans): the duration of the window's
decode calls, from the call into the runner until it returns, over their
fused steps (:func:`portbench.recorder.decode_calls`). On the pipelined
path the host enqueues while the card still runs the window before, and
a dispatch blocks once the card's launch queue is full: the figure reads
max(host enqueue, card pace), and shows the host's own enqueue only
where the card is faster than the host. Where it is within a few percent
of ``decode_device_ms``, the card paces and the enqueue is not seen."""

from portbench import recorder


def read(run):
    calls = recorder.decode_calls(run)
    if not calls:
        return None
    steps = sum(int(recorder.attr(c, "steps") or 0) for c in calls)
    return 1e3 * sum(c["dur_s"] for c in calls) / steps if steps else None
