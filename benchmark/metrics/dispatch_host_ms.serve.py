"""Host milliseconds of a ``Predictor.dispatch_async`` call (bucket, pad,
pin, upload, enqueue), from the benchmark's span around it."""


def read(run):
    spans = run.spans.seconds.get("dispatch")
    return sum(spans) / len(spans) * 1e3 if spans else None
