"""The span probe's reduction (``benchmark/probes/spans_probe.py``) on the
hand-built trace of ``test_bench_metrics``, with the program's ``mvdetr:*``
annotations laid over the hooks' ``bench:*`` spans: each span twin reads
what its hook metric reads."""

import pytest

from benchmark.harness.trace import reduce_trace
from benchmark.probes import spans_probe
from benchmark.run import load_layers
from benchmark.tests.test_bench_metrics import EVENTS, op

SPANS = [
    op("mvdetr:trunk", 1, 5, 100, cat="user_annotation"),
    op("mvdetr:norm", 1, 10, 20, cat="user_annotation"),
    op("mvdetr:eval_step", 1, 690, 270, cat="user_annotation"),
    op("mvdetr:upload", 1, 700, 50, cat="user_annotation"),
    op("mvdetr:nms", 1, 800, 150, cat="user_annotation"),
    op("mvdetr:feed.stage", 3, 20, 300, cat="user_annotation"),
    op("mvdetr:feed.stage", 3, 400, 100, cat="user_annotation"),
    op("mvdetr:feed.wait", 1, 0, 4, cat="user_annotation"),
]


@pytest.fixture
def readings():
    events = EVENTS + SPANS
    rec = reduce_trace(events, load_layers())
    rec["units"] = 1
    return spans_probe.span_readings(events, rec)


def test_span_twins_read_what_the_hooks_read(readings):
    for name, want in (("trunk", 0.16), ("norm", 0.08)):
        assert readings[f"span_device_ms.{name}"] == pytest.approx(want)
        assert readings[f"span_device_ms.{name}"] == pytest.approx(readings[f"hook.device_ms.{name}"])
    assert readings["span_h2d_ms"] == pytest.approx(0.04) == pytest.approx(readings["hook.h2d_ms"])
    assert readings["span_device_ms.attention"] is None and readings["span_device_ms.warp"] is None


def test_feed_eval_idle_and_gap_names(readings):
    assert readings["feed_counts"] == [2, 1]
    assert readings["feed_stage_ms"] == pytest.approx(0.2)  # (300 + 100) us over two batches
    assert readings["feed_wait_ms"] == pytest.approx(0.004)
    assert readings["eval_span_ms"] == pytest.approx(0.27)
    assert readings["eval_idle_ms"] == pytest.approx(0.23)  # 270 us less the upload's 40 us HtoD copy
    # 760..1000 is idle with its middle inside NMS; 0..100 inside the trunk
    assert readings["idle_ms_by_span"]["mvdetr:nms"] == pytest.approx(0.24)
    assert readings["idle_ms_by_span"]["mvdetr:trunk"] == pytest.approx(0.1)
