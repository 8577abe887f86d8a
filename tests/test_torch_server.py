"""The port's MaskServer / MaskClient: the HTTP scenarios the JAX package's
tests hold its server to (tests/test_pipelines.py), against the port, on
localhost, with a stub predictor. The round trip on the port's Predictor
and the int8 CLI are in ``test_torch_server_int8.py``."""

import io
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from weaklysuperviseddl_tpu_torch.pipelines.serve import MaskClient, MaskServer


class _StubPredictor:
    """Duck-typed Predictor: the MaskServer worker only touches max_batch,
    dispatch_async and readback, so gates on those calls make queue-full and
    device-wedged states deterministic."""

    def __init__(self, dispatch_gate=None, readback_gate=None, max_batch=1):
        self.max_batch = max_batch
        self.dispatch_gate = dispatch_gate
        self.readback_gate = readback_gate
        self.dispatch_count = 0
        self.dispatched = threading.Event()

    def dispatch_async(self, images):
        self.dispatch_count += 1
        self.dispatched.set()
        if self.dispatch_gate is not None:
            assert self.dispatch_gate.wait(30)
        return np.zeros(images.shape[:-1], np.uint8), images.shape[0]

    def readback(self, dev, n):
        if self.readback_gate is not None:
            assert self.readback_gate.wait(30)
        return np.asarray(dev)[:n]


def _post_npy(port, img, timeout=30):
    """POST an np.save body; returns (status, mask or None, headers)."""
    buf = io.BytesIO()
    np.save(buf, img)
    try:
        req = urllib.request.Request(f"http://127.0.0.1:{port}/predict",
                                     data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, np.load(io.BytesIO(r.read()), allow_pickle=False), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, None, dict(e.headers)


def _wait_until(cond, what, timeout=10):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.005)


def test_mask_server_sheds_503_when_queue_full():
    gate = threading.Event()
    stub = _StubPredictor(dispatch_gate=gate)
    server = MaskServer(stub, max_wait_ms=1.0, in_flight=1, max_queue=1,
                        request_timeout_s=30.0).start()
    img = np.zeros((8, 8, 3), np.uint8)
    try:
        results = {}

        def post(key):
            results[key] = _post_npy(server.port, img)

        ta = threading.Thread(target=post, args=("a",))
        ta.start()
        assert stub.dispatched.wait(10)  # a holds the device
        tb = threading.Thread(target=post, args=("b",))
        tb.start()
        _wait_until(lambda: server._queue.qsize() >= 1, "b never queued")
        status, _, headers = _post_npy(server.port, img)
        assert status == 503 and headers.get("Retry-After") == "1"
        gate.set()
        ta.join(timeout=30)
        tb.join(timeout=30)
        assert results["a"][0] == 200 and results["b"][0] == 200
        stats = MaskClient(f"http://127.0.0.1:{server.port}").stats()
        assert stats["total_shed_503"] == 1 and stats["total_timeouts_504"] == 0
        assert stats["latency_window"] == 2
        assert stats["latency_p99_ms"] >= stats["latency_p50_ms"] > 0
    finally:
        gate.set()
        server.stop()


def test_mask_server_rejects_oversized_and_negative_body_413():
    import http.client

    server = MaskServer(_StubPredictor(), max_body_bytes=1024).start()
    try:
        assert _post_npy(server.port, np.zeros((64, 64, 3), np.uint8))[0] == 413
        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=30)
        try:
            conn.putrequest("POST", "/predict")
            conn.putheader("Content-Length", "-1")
            conn.endheaders()
            assert conn.getresponse().status == 413
        finally:
            conn.close()
        status, mask, _ = _post_npy(server.port, np.zeros((8, 8, 3), np.uint8))
        assert status == 200 and mask.shape == (8, 8)
        assert server.total_rejected == 2
    finally:
        server.stop()


def test_mask_client_url_handling():
    c = MaskClient("http://example.com:8080/masks/")
    assert (c._scheme, c._host, c._port, c._prefix) == ("http", "example.com", 8080, "/masks")
    c = MaskClient("https://example.com")
    assert c._scheme == "https" and c._port is None and c._prefix == ""
    with pytest.raises(ValueError):
        MaskClient("ftp://example.com")
    with pytest.raises(ValueError):
        MaskClient("http://example.com", wire="jpeg")


def test_mask_server_error_responses_stay_out_of_latency_stats():
    class _Faulty(_StubPredictor):
        def readback(self, dev, n):
            raise ValueError("injected device fault")

    server = MaskServer(_Faulty()).start()
    try:
        assert _post_npy(server.port, np.zeros((8, 8, 3), np.uint8))[0] == 500
        assert MaskClient(f"http://127.0.0.1:{server.port}").stats().get("latency_window", 0) == 0
    finally:
        server.stop()


def test_mask_server_times_out_504_when_device_wedges():
    gate = threading.Event()
    server = MaskServer(_StubPredictor(dispatch_gate=gate), request_timeout_s=0.3).start()
    try:
        assert _post_npy(server.port, np.zeros((8, 8, 3), np.uint8))[0] == 504
        assert server.total_timeouts == 1
    finally:
        gate.set()
        server.stop()


def test_mask_server_dispatches_ahead_of_readback():
    """With the first readback still blocked, a second request still reaches
    dispatch_async: the dispatch loop runs ahead of the drain loop."""
    gate = threading.Event()
    stub = _StubPredictor(readback_gate=gate)
    server = MaskServer(stub, max_wait_ms=1.0, in_flight=4).start()
    img = np.zeros((8, 8, 3), np.uint8)
    try:
        results = {}
        threads = [threading.Thread(target=lambda k=k: results.__setitem__(
            k, _post_npy(server.port, img))) for k in "ab"]
        threads[0].start()
        assert stub.dispatched.wait(10)
        threads[1].start()
        _wait_until(lambda: stub.dispatch_count >= 2, "second dispatch never happened")
        gate.set()
        for t in threads:
            t.join(timeout=30)
        assert results["a"][0] == 200 and results["b"][0] == 200
    finally:
        gate.set()
        server.stop()


def test_mask_server_adaptive_coalescing_grows_batches_at_saturation():
    """Once the in-flight queue is full, the dispatcher keeps coalescing past
    max_wait_ms, so later requests go out as one batch."""
    gate = threading.Event()
    stub = _StubPredictor(readback_gate=gate, max_batch=4)
    server = MaskServer(stub, max_wait_ms=1.0, in_flight=1).start()
    img = np.zeros((8, 8, 3), np.uint8)
    try:
        results = {}

        def post(key):
            results[key] = _post_npy(server.port, img)

        ta = threading.Thread(target=post, args=("a",))
        ta.start()
        assert stub.dispatched.wait(10)
        tb = threading.Thread(target=post, args=("b",))
        tb.start()
        _wait_until(lambda: stub.dispatch_count >= 2, "b never dispatched")
        rest = [threading.Thread(target=post, args=(k,)) for k in "cde"]
        for t in rest:
            t.start()
            time.sleep(0.05)
        _wait_until(lambda: server._queue.qsize() == 0 and server.total_requests >= 5,
                    "c/d/e never queued")
        time.sleep(0.1)  # the dispatcher is parked in the adaptive window
        assert stub.dispatch_count == 2
        gate.set()
        for t in [ta, tb] + rest:
            t.join(timeout=30)
        assert all(results[k][0] == 200 for k in "abcde"), results
        assert list(server.dispatch_sizes) == [1, 1, 3]
    finally:
        gate.set()
        server.stop()


def test_cli_serve_smoke_on_cpu(capsys):
    """``serve --smoke --device cpu``: builds the smoke model, serves, sends one
    request through MaskClient and exits."""
    from weaklysuperviseddl_tpu_torch.cli import main

    assert main(["serve", "--smoke", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "smoke round trip OK: mask (48, 48)" in out


@pytest.mark.parametrize("flag", ["--calib-dir", "--checkpoint=w.pt"])
def test_cli_serve_refuses_what_is_not_ported(flag, tmp_path):
    """``--calib-dir`` of a directory with no images, and ``--checkpoint`` of
    a file that does not exist, are usage errors (exit code 2)."""
    from weaklysuperviseddl_tpu_torch.cli import main

    if flag == "--calib-dir":
        (tmp_path / "notes.txt").write_text("not an image")
        flag = f"--calib-dir={tmp_path}"
    with pytest.raises(SystemExit) as e:
        main(["serve", "--smoke", "--device", "cpu", flag])
    assert e.value.code == 2


def test_cli_client_reports_unreachable_server(capsys):
    from weaklysuperviseddl_tpu_torch.cli import main

    # port 9 on localhost (discard) has no MaskServer behind it
    assert main(["client", "--url", "http://127.0.0.1:9", "--stats"]) == 1
    assert "cannot reach" in capsys.readouterr().err
