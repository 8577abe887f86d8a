"""K2's share of its roofline on the served batches: ``counts.cc_bound_ms``
of a batch of masks against the traced unit's ``cc_*`` kernel time a
labelling call."""

from benchmark import counts, readings


def read(run):
    calls = (run.extra.get("traced_launches") or {}).get("label_components_cuda")
    ms = readings.kernel_ms(run, r"\bcc_(image|local|border|compress)\b")
    if not calls or ms is None:
        return None
    size = run.config["image_size"]
    return readings.share(counts.cc_bound_ms(run.params["max_batch"], size, size), ms / calls)
