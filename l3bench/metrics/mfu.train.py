"""Model FLOP utilisation of training on one card, in %: the forward of
both towers and the head and its two backward products
(``counts.pair_train_flops``; BatchNorm and elementwise work left out) for
each pair of the traced run's whole window, over that window's time and the
bf16 peak."""

from l3bench import counts, readers


def read(rec):
    return readers.mfu(rec, "pairs", counts.pair_train_flops)
