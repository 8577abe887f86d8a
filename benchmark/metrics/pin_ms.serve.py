"""Host milliseconds a batch that ``Predictor`` spends pinning the batch's
host memory, from the program's ``serve/pin`` spans in the traced unit."""

from benchmark import program_spans


def read(run):
    return program_spans.per(run, "serve/pin", "serve/dispatch")
