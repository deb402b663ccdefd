"""Real 1 s windows embedded a second, over the whole window: every row the
extractor returned (padding rows of a bucket are not rows), over the time
from the first dispatch to the last rows on the host."""

from l3bench import readers


def read(rec):
    return readers.rate(rec, "windows")
