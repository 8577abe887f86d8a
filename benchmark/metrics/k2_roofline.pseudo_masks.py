"""K2's share of its roofline on the derived masks: ``counts.cc_bound_ms``
of a batch against the traced pass's ``cc_*`` kernel time a labelling call."""

from benchmark import counts, readings


def read(run):
    calls = run.extra.get("traced_k2_launches")
    ms = readings.kernel_ms(run, r"\bcc_(image|local|border|compress)\b")
    if not calls or ms is None:
        return None
    size = run.params["image_size"]
    return readings.share(counts.cc_bound_ms(run.extra["batch"], size, size), ms / calls)
