"""Mean host milliseconds inside ``train_step`` a step, over the window."""


def read(rec, ctx):
    steps = rec["dispatch_s"]
    return 1e3 * sum(steps) / len(steps) if steps else None
