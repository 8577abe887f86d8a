"""Q2's share of its roofline: the bytes of one int8 forward's epilogues
(``counts.q2_bytes`` over its calls) over HBM bandwidth, against the traced
unit's ``dequant_epilogue`` kernel time a forward."""

from benchmark import counts, readings


def read(run):
    calls = (run.extra.get("traced_launches") or {}).get("dequant_epilogue")
    ms = readings.kernel_ms(run, r"\bdequant_epilogue\b")
    if not calls or ms is None or not run.extra.get("q2_calls"):
        return None
    forwards = calls / run.extra["q2_calls"]
    bound, _ = counts.roofline(run.extra["q2_bytes"], 0.0)
    return readings.share(bound, ms / forwards)
