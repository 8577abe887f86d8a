"""Milliseconds a batch of the window's ``extract_cams`` calls, from the
benchmark's span around each call (the loader's drain and the upload
included) over the pass's batches."""


def read(run):
    spans = run.spans.seconds.get("extract")
    if not spans:
        return None
    return sum(spans) / (len(spans) * run.extra["batches_per_pass"]) * 1e3
