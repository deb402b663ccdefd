"""Set-up time: from the start of the run's process to the start of the
window (imports, CUDA context, the kernel library, on several cards the
ranks' launch and the process group, weights and inputs made from the seed,
the checked steps of a training cell, warm-up of the cell's own shapes
until the card is steady)."""


def read(rec):
    return rec["setup_s"]
