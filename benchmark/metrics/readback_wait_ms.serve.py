"""Host milliseconds a ``Predictor.readback`` call waits for its batch and
unpacks it, from the benchmark's span around it."""


def read(run):
    spans = run.spans.seconds.get("readback")
    return sum(spans) / len(spans) * 1e3 if spans else None
