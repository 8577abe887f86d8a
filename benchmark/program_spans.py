"""The program's own spans of the traced unit, for the readers of the
``program_span`` metrics.

``utils/profiling.span`` records only while a ``torch.profiler`` session
records, which in a run is the traced unit alone. The first reader of a run
takes the recorded spans out of the program's buffer
(``profiling.take_spans``) and keeps them in ``run.extra``, with their totals
by name under ``notes`` (``spans``: count, total ms, self ms). A program
without spans gives None, and every reader then returns None."""

from __future__ import annotations


def spans(run) -> list | None:
    """The traced unit's spans, or None where the program records none."""
    if "program_spans" not in run.extra:
        try:
            from weaklysuperviseddl_tpu_torch.utils.profiling import span_totals, take_spans
        except ImportError:
            taken = None
        else:
            taken = take_spans() or None
            if taken:
                run.extra.setdefault("notes", {})["spans"] = {
                    name: [t["count"], round(t["total_ms"], 3), round(t["self_ms"], 3)]
                    for name, t in span_totals(taken).items()}
        run.extra["program_spans"] = taken
    return run.extra["program_spans"]


def total_ms(run, name: str) -> float | None:
    """Summed milliseconds of the traced unit's spans ``name``, or None
    where there is none."""
    found = [sp.seconds for sp in spans(run) or () if sp.name == name]
    return sum(found) * 1e3 if found else None


def per(run, name: str, per_name: str) -> float | None:
    """Milliseconds of spans ``name`` for each span ``per_name`` (a batch's
    ``serve/dispatch``, a pass's ``pseudo/drain``), or None."""
    ms = total_ms(run, name)
    count = sum(sp.name == per_name for sp in spans(run) or ())
    return ms / count if ms is not None and count else None
