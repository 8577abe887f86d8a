"""Q1's share of its roofline: the bytes of one int8 forward's gathers
(``counts.q1_bytes`` over its calls, at the batch shape) over HBM
bandwidth, against the traced unit's ``quantize_gather`` kernel time a
forward."""

from benchmark import counts, readings


def read(run):
    calls = (run.extra.get("traced_launches") or {}).get("quantize_gather")
    ms = readings.kernel_ms(run, r"\bquantize_gather\b")
    if not calls or ms is None or not run.extra.get("q1_calls"):
        return None
    forwards = calls / run.extra["q1_calls"]
    bound, _ = counts.roofline(run.extra["q1_bytes"], 0.0)
    return readings.share(bound, ms / forwards)
