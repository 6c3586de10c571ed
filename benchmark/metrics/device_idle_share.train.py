"""The share of the traced window in which no operation ran on the card, in %."""


def read(rec, ctx):
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
