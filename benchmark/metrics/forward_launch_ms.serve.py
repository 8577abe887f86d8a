"""Host milliseconds a batch to enqueue the forward, K2, the packing and the
readback copy, from the program's ``serve/forward`` spans in the traced
unit."""

from benchmark import program_spans


def read(run):
    return program_spans.per(run, "serve/forward", "serve/dispatch")
