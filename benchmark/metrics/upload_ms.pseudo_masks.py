"""Host milliseconds a pass of ``extract_cams``' upload of the drained images
and labels, from the program's ``pseudo/upload`` spans in the traced unit."""

from benchmark import program_spans


def read(run):
    return program_spans.per(run, "pseudo/upload", "pseudo/drain")
