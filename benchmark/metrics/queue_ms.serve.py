"""Mean milliseconds from a request's due time to the start of its
service, over the window."""


def read(rec, ctx):
    waits = rec["queue_s"]
    return 1e3 * sum(waits) / len(waits) if waits else None
