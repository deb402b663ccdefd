"""Model FLOP utilisation of the Whisper encoder, in %: the operations of
one window through the encoder (``counts_whisper.window_flops``: its
linears, attention cores and stem) for each window of the run's whole
window, over that window's time and the bf16 peak (989 TFLOP/s)."""

from l3bench import counts_whisper, readers


def read(rec):
    return readers.mfu(rec, "windows", counts_whisper.window_flops)
