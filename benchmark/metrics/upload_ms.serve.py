"""Host milliseconds a batch of ``Predictor``'s ``non_blocking`` upload from
pinned memory, from the program's ``serve/upload`` spans in the traced
unit."""

from benchmark import program_spans


def read(run):
    return program_spans.per(run, "serve/upload", "serve/dispatch")
