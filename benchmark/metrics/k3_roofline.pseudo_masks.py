"""K3's share of its roofline in the CRF: the least time of the traced
pass's bilateral-filter calls (``counts.bilateral_work`` from each call's
queries, keys, features and values) against the trace's time of the
``pack_keys`` and ``bilateral_*`` kernels. The CUDA events the benchmark
records around the same calls are reported beside it, as notes, with a flag
where the two times part (``counts.times_part``)."""

from benchmark import counts, readings


def read(run):
    calls = run.extra.get("traced_k3_calls")
    if not calls:
        return None
    bound = sum(counts.roofline(*counts.bilateral_work(B, Nq, Nk, d, C))[0]
                for _, _, B, Nq, Nk, d, C in calls)
    events = sum(start.elapsed_time(end) for start, end, *_ in calls)
    trace = readings.kernel_ms(run, r"\b(pack_keys|bilateral_packed|bilateral_general)\b")
    notes = run.extra.setdefault("notes", {})
    notes.update({"k3_bound_ms": bound, "k3_trace_ms": trace, "k3_events_ms": events,
                  "k3_times_part": counts.times_part(trace, events)})
    return readings.share(bound, trace)
