"""Model FLOP utilisation of extraction, in %: 2 x the MACs of every audio
conv (``counts.window_flops``) for each real window of the traced run's
whole window, over that window's time and the cell's peak."""

from l3bench import counts, readers


def read(rec):
    return readers.mfu(rec, "windows", counts.window_flops)
