"""Host milliseconds a request inside ``decode_detections`` (decode, top
candidates, NMS with its host syncs), entered with the card idle."""


def read(rec, ctx):
    spans = rec["host_spans"].get("decode_nms", [])
    return sum(spans) / len(spans) / 1e3 if spans else None
