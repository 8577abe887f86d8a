"""Milliseconds a batch of the window's ``masks_from_cams`` calls (the
threshold, the CRF where the cell has it, the largest component, the
readback and the store's fill), from the benchmark's span around each call,
over the pass's batches."""


def read(run):
    spans = run.spans.seconds.get("derive")
    if not spans:
        return None
    return sum(spans) / (len(spans) * run.extra["batches_per_pass"]) * 1e3
