"""Host milliseconds a pass that ``masks_from_cams`` takes to read the masks
and the store images back (the wait for the derive stage's device work
included), from the program's ``pseudo/readback`` spans in the traced
unit."""

from benchmark import program_spans


def read(run):
    return program_spans.per(run, "pseudo/readback", "pseudo/drain")
