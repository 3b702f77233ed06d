"""The model's share of the chip's bf16 peak (``models/transformer.py``):
the operations of the window's tokens (2 x active parameters a token,
attention over each token's context, the output head where logits are
made; a shared template's positions once, as the runner prefills them)
over 989 TFLOP/s and the window's seconds, in percent."""

from portbench import work


def read(run):
    if run.peaks is None:
        return None
    flops = work.model_flops(run)
    return 100.0 * flops / (run.peaks[1] * run.window_s) if flops else None
