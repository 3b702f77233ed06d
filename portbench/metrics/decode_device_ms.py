"""Device milliseconds of a fused decode step (``models/transformer.py``):
the card's time on the window's decode calls, from the program's CUDA
events around each call (``device_s``), over their fused steps
(:func:`portbench.recorder.decode_calls`). Idle inside a call counts."""

from portbench import recorder


def read(run):
    got = recorder.decode_device(run)
    return 1e3 * got[1] / got[0] if got else None
