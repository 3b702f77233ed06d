"""Share of the window the card spends outside the program's timed calls
(``engine/scheduler.py``): the sum of the calls' ``gap_s`` (CUDA events:
the previous timed call's end to this call's start, idle or work no
timed call enqueued) over the window, in percent."""

from portbench import recorder

CALLS = ("prefill", "admit", "decode_window")


def read(run):
    calls = recorder.spans(run, CALLS)
    if calls is None:
        return None
    gaps = [recorder.attr(c, "gap_s") for c in calls]
    gaps = [g for g in gaps if g is not None]
    return 100.0 * sum(gaps) / run.window_s if gaps else None
