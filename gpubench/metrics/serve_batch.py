"""serve_batch: mean number of requests a ``GNNService.flush`` served
in the window."""


def read(rec):
    sizes = rec.spans.spans.get("batch")
    return sum(sizes) / len(sizes) if sizes else None
