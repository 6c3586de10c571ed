"""Device milliseconds of the host-to-device copies inside the upload
(``batch_to_device``) a request."""

from benchmark.harness.trace import layer_seconds


def read(rec, ctx):
    s = layer_seconds(rec, "upload", cat="gpu_memcpy", name_part="HtoD")
    return 1e3 * s / rec["units"] if s > 0 else None
