"""Audio-video pairs trained a second on one card, over the whole window:
every step's batch, over the time from the first step's dispatch to the
last step's end on the card."""

from l3bench import readers


def read(rec):
    return readers.rate(rec, "pairs")
