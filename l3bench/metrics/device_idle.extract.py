"""Share of the traced stretch in which no operation ran on the device, in
% (``readers.idle``); on several cards, of the means over them."""

from l3bench import readers


def read(rec):
    return readers.idle(rec)
