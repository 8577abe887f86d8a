"""Percent of the traced call's ``serve/dispatch`` spans that began while an
earlier dispatch of the predictor was still running on the card (the span's
``pending`` is 1 or more): how often ``predict_many``'s batches in flight
overlap. None where no ``serve/dispatch`` span carries ``pending``."""

from benchmark import program_spans


def read(run):
    pending = [sp.attrs["pending"] for sp in program_spans.spans(run) or ()
               if sp.name == "serve/dispatch" and "pending" in sp.attrs]
    return 100.0 * sum(p >= 1 for p in pending) / len(pending) if pending else None
