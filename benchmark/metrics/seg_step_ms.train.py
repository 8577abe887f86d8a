"""Milliseconds a training step, from the program's ``Stopwatch`` phase
``seg_training`` (it ends in a synchronize) over the rounds' steps."""


def read(run):
    sw = run.extra.get("stopwatch")
    if sw is None or not sw.counts["seg_training"]:
        return None
    steps = sw.counts["seg_training"] * run.extra["steps_per_round"]
    return sw.times["seg_training"] / steps * 1e3
