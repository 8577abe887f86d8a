"""Milliseconds a refinement-sweep batch, from the program's ``Stopwatch``
phase ``refinement_sweeps`` over the rounds' batches."""


def read(run):
    sw = run.extra.get("stopwatch")
    if sw is None or not sw.counts["refinement_sweeps"]:
        return None
    batches = sw.counts["refinement_sweeps"] * run.extra["sweep_batches_per_round"]
    return sw.times["refinement_sweeps"] / batches * 1e3
