"""serve_flush_ms: mean host milliseconds of a ``GNNService.flush`` in
the window, from the call to the synchronisation after it (the
harness's ``flush`` span)."""


def read(rec):
    spans = rec.spans.spans.get("flush")
    return 1e3 * sum(spans) / len(spans) if spans else None
