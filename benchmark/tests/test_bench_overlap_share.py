"""The reader of ``overlap_share.serve``: None where the program records no
``serve/dispatch`` span with ``pending``, the share of dispatches that found
an earlier one still running where it does, and a number in a tiny traced
serving run on the CPU."""

from __future__ import annotations

import math
import types

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny

SERVE = "serve.deeplabv3_r50_os8.int8_b64"


def _dispatches(*pending):
    from weaklysuperviseddl_tpu_torch.utils.profiling import Span

    spans = [Span("serve/dispatch", {"dispatch": i, "images": 64, **p})
             for i, p in enumerate(pending)]
    return spans + [Span("serve/forward", {"dispatch": 0})]


@pytest.mark.parametrize("spans,share", [
    (None, None),                                            # the program records none
    (_dispatches({}, {}), None),                             # spans without ``pending``
    (_dispatches(*[{"pending": p} for p in (0, 1, 4, 3)]), 75.0),
    (_dispatches(*[{"pending": 0}] * 3), 0.0),
    (_dispatches({"pending": 0}, *[{"pending": 2}] * 15), 93.75),
])
def test_overlap_share_reads_the_dispatch_spans(spans, share):
    run = types.SimpleNamespace(extra={"program_spans": spans})
    assert harness.reader("overlap_share.serve").read(run) == share


def test_overlap_share_in_a_traced_run():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 4))
    try:
        result, _ = tiny.run(SERVE, trace=True)
    finally:
        torch.set_num_threads(threads)
    assert result["correct"], result["compared"]
    assert math.isfinite(result["metrics"]["overlap_share.serve"]["value"])
