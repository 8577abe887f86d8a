"""The port's spans (``utils/profiling.span``) on the CPU: off they record
nothing and cost nothing but a flag read; under ``profiling.trace`` a tiny
``Predictor`` call leaves its ``wsdl/serve/*`` ranges in the Chrome trace and
its spans, with parents and self times, in ``spans.json``; the device's idle
gaps are named by the innermost ``wsdl/`` range; and a ``MaskServer``
request reports every stage in ``/stats``."""

import json
import time
import tracemalloc

import numpy as np
import pytest
import torch
from test_torch_server import _post_npy

from weaklysuperviseddl_tpu_torch.models.deeplabv3 import DeepLabV3
from weaklysuperviseddl_tpu_torch.models.resnet import init_weights
from weaklysuperviseddl_tpu_torch.pipelines.serve import MaskClient, MaskServer, Predictor
from weaklysuperviseddl_tpu_torch.utils import profiling

SIZE = 32


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two threads: the suite's workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def predictor():
    model = init_weights(DeepLabV3(2, 18, 0.25), torch.Generator().manual_seed(0))
    return Predictor(model, size=SIZE, max_batch=2, device="cpu")


def _images(n):
    return (np.random.default_rng(3).uniform(0, 1, (n, SIZE, SIZE, 3)) * 255).astype(np.uint8)


def test_span_off_records_nothing_and_allocates_nothing(monkeypatch):
    assert not torch.autograd.profiler._is_profiler_enabled
    profiling.take_spans()

    def entered(*args, **kwargs):
        raise AssertionError("a span with the profiler off made a Span, entered "
                             "record_function or synced")

    for owner, name in ((torch.profiler, "record_function"), (torch.cuda, "synchronize"),
                        (profiling, "Span")):
        monkeypatch.setattr(owner, name, entered)
    assert profiling.span("a") is profiling.span("b", bytes=1)   # one shared no-op

    def spans(n):
        for i in range(n):
            with profiling.span("x", bytes=i):
                pass
            profiling.record_span("y", 0.0, 1.0, rid=i)

    spans(10)
    here = tracemalloc.Filter(True, __file__), tracemalloc.Filter(True, profiling.__file__)
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot().filter_traces(here)
        spans(20000)
        after = tracemalloc.take_snapshot().filter_traces(here)
    finally:
        tracemalloc.stop()
    # a byte kept by a span would come to 20,000 of them
    kept = sum(d.size_diff for d in after.compare_to(before, "filename"))
    assert kept < 512, kept
    assert profiling.take_spans() == []


def test_trace_of_a_predictor_call(predictor, tmp_path):
    with profiling.trace(str(tmp_path)):
        masks = predictor.predict_many(_images(3))
    assert masks.shape == (3, SIZE, SIZE)
    with open(tmp_path / "trace.json") as f:
        ranges = {e["name"] for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "user_annotation"}
    serve = {"serve/dispatch", "serve/pad", "serve/forward", "serve/readback", "serve/wait",
             "serve/unpack"}
    assert {profiling.SPAN_PREFIX + name for name in serve} <= ranges
    with open(tmp_path / "spans.json") as f:
        summary = json.load(f)
    spans = summary["spans"]
    assert serve <= set(spans) and summary["idle_gaps"] == []      # no device on the CPU
    assert spans["serve/dispatch"]["count"] == 2                  # buckets 2 and 1
    assert spans["serve/pad"]["parents"] == ["serve/dispatch"]
    assert spans["serve/wait"]["parents"] == ["serve/readback"]
    for parent, children in (("serve/dispatch", ("serve/pad", "serve/forward")),
                             ("serve/readback", ("serve/wait", "serve/unpack"))):
        want = spans[parent]["total_ms"] - sum(spans[c]["total_ms"] for c in children)
        assert spans[parent]["self_ms"] == pytest.approx(want, abs=1e-6)
        for c in children:
            assert spans[c]["self_ms"] == pytest.approx(spans[c]["total_ms"])
    assert profiling.take_spans() == []                           # the trace took them


def test_idle_gaps_named_by_the_innermost_span():
    def x(name, cat, ts, dur):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}

    events = [x("k", "kernel", 0, 10), x("k", "kernel", 30, 10), x("copy", "gpu_memcpy", 100, 10),
              x("k", "kernel", 130, 10), x("k", "kernel", 220, 10),
              x("wsdl/serve/dispatch", "user_annotation", 5, 55),
              x("wsdl/serve/pin", "user_annotation", 8, 27),
              x("wsdl/pseudo/store", "user_annotation", 90, 30),
              x("bench/unit", "user_annotation", 0, 300),
              {"ph": "i", "name": "wsdl/marker", "ts": 12}]
    gaps = profiling.idle_gaps(events)
    assert [(g["span"], g["ms"], g["at_ms"]) for g in gaps] == [
        (None, 0.08, 0.14), ("serve/dispatch", 0.06, 0.04), ("serve/pin", 0.02, 0.01),
        ("pseudo/store", 0.02, 0.11)]


def test_mask_server_reports_every_stage(predictor):
    server = MaskServer(predictor, max_wait_ms=1.0).start()
    try:
        status, mask, _ = _post_npy(server.port, _images(1)[0])
        assert status == 200 and mask.shape == (SIZE, SIZE)
        client = MaskClient(f"http://127.0.0.1:{server.port}")
        deadline = time.monotonic() + 10
        while not server.stage_s:         # the handler adds its stages after the write
            assert time.monotonic() < deadline
            time.sleep(0.005)
        stats = client.stats()
        for key in ("stage_p50_ms", "stage_p99_ms"):
            assert list(stats[key]) == list(MaskServer.STAGES)
            assert all(v >= 0 for v in stats[key].values())
        # one request: accept to the handler's wake is the latency
        stages = stats["stage_p50_ms"]
        assert abs(sum(stages.values()) - stages["respond"] - stats["latency_p50_ms"]) < 1.0

        profiling.take_spans()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            assert client.predict(_images(1)[0]).shape == (SIZE, SIZE)
            while len(server.stage_s) < 2:
                assert time.monotonic() < deadline
                time.sleep(0.005)
        client.close()
        spans = profiling.take_spans()
        http = {sp.name: sp.attrs["rid"] for sp in spans if sp.name.startswith("http/")}
        assert set(http) == {f"http/{s}" for s in MaskServer.STAGES} - {
            "http/dispatch", "http/readback"}
        assert set(http.values()) == {1}
        assert {"serve/dispatch", "serve/readback"} <= {sp.name for sp in spans}
    finally:
        server.stop()
