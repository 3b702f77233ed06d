"""Share of the traced window in which no operation ran on the device
(H100): one less the union of the trace's operation intervals over the
window, in percent."""


def read(run):
    if not run.ops:
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)
