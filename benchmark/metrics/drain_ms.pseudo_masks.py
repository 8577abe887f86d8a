"""Host milliseconds a pass that ``extract_cams`` takes to drain the loader
and concatenate its batches, from the program's ``pseudo/drain`` span in the
traced unit."""

from benchmark import program_spans


def read(run):
    return program_spans.per(run, "pseudo/drain", "pseudo/drain")
