"""Host milliseconds a pass of ``masks_from_cams``' ``MaskStore`` puts and
flush, from the program's ``pseudo/store`` spans in the traced unit."""

from benchmark import program_spans


def read(run):
    return program_spans.per(run, "pseudo/store", "pseudo/drain")
