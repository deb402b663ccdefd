"""Host time to enqueue one train step, in ms, from the harness's span
around the ``make_train_step`` call: the step returns before the card
finishes, so this is the launches of the forward, backward and Adam (and
any wait the step itself makes). Averaged over the window's steps outside
the traced stretch."""


def read(rec):
    return None if rec.get("enqueue_s") is None else 1e3 * rec["enqueue_s"]
