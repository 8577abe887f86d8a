"""The port's MaskServer / MaskClient: the HTTP scenarios the JAX package's
tests hold its server to (tests/test_pipelines.py), against the port, on
localhost. Structural cases use a stub predictor; the round trip uses the
port's Predictor on the CPU."""

import io
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from weaklysuperviseddl_tpu_torch.models.deeplabv3 import DeepLabV3
from weaklysuperviseddl_tpu_torch.models.resnet import init_weights
from weaklysuperviseddl_tpu_torch.pipelines.serve import MaskClient, MaskServer, Predictor


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


def test_mask_server_round_trip_on_port_predictor():
    """Concurrent POSTs coalesce into batched dispatches and return exactly the
    Predictor's masks; 400 on a malformed body, 404 on unknown paths; PNG in
    and out; /healthz and /stats."""
    model = init_weights(DeepLabV3(2, 18, 0.25), torch.Generator().manual_seed(0))
    pred = Predictor(model, size=48, max_batch=4, device="cpu").warmup()
    server = pred.serve_http(max_wait_ms=1000.0)  # wide window: deterministic coalescing
    base = f"http://127.0.0.1:{server.port}"
    try:
        rng = np.random.default_rng(5)
        imgs = (rng.uniform(0, 1, (6, 48, 48, 3)) * 255).astype(np.uint8)
        want = np.concatenate([pred(imgs[:4]), pred(imgs[4:])])
        results = [None] * len(imgs)
        ready = threading.Barrier(len(imgs))

        def post(i):
            ready.wait(timeout=30)
            results[i] = _post_npy(server.port, imgs[i])[1]

        threads = [threading.Thread(target=post, args=(i,)) for i in range(len(imgs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        for i in range(len(imgs)):
            np.testing.assert_array_equal(results[i], want[i])
        sizes = server.drain_dispatch_sizes()
        assert max(sizes) > 1 and sum(sizes) == len(imgs), sizes
        assert not server.dispatch_sizes

        req = urllib.request.Request(base + "/predict", data=b"not an npy", method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == 400

        # compressed bodies: PNG request in, 1-bit PNG mask out
        from PIL import Image

        png = io.BytesIO()
        Image.fromarray(imgs[0]).save(png, format="PNG")
        req = urllib.request.Request(base + "/predict", data=png.getvalue(), method="POST",
                                     headers={"Content-Type": "image/png",
                                              "Accept": "image/png"})
        with urllib.request.urlopen(req, timeout=30) as r:
            assert r.headers["Content-Type"] == "image/png"
            body = r.read()
        mask = (np.asarray(Image.open(io.BytesIO(body)).convert("L")) > 0).astype(np.uint8)
        np.testing.assert_array_equal(mask, want[0])

        for wire in ("npy", "png"):
            np.testing.assert_array_equal(MaskClient(base, wire=wire).predict(imgs[1]), want[1])
        n_client_posts = 2

        health = MaskClient(base).healthz()
        assert health == {"status": "ok", "size": 48, "max_batch": 4, "buckets": [1, 2, 4],
                          "int8": False, "packed": False}
        stats = MaskClient(base).stats()
        # 6 posts + the 400 + the PNG + the client posts; the 400 carried no image
        assert stats["total_requests"] == len(imgs) + 2 + n_client_posts
        assert stats["total_images"] == len(imgs) + 1 + n_client_posts
        assert stats["mean_dispatch_size"] > 1.0 and stats["uptime_s"] > 0

        for method, path in (("POST", "/frob"), ("GET", "/")):
            req = urllib.request.Request(base + path, data=b"x" if method == "POST" else None,
                                         method=method)
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(req, timeout=30)
            assert e.value.code == 404
        assert MaskClient(base).stats()["total_requests"] == stats["total_requests"]
    finally:
        server.stop()


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


def test_cli_serve_int8_with_calibration_state(tmp_path, capsys, monkeypatch):
    """``serve --int8 --calib-state`` outside smoke mode, with the smoke
    model at 48², batch 2 and port 0 (its class-1 bias raised by 10, so that
    its masks are decided and int8 passes the agreement gate): the first run
    calibrates on synthetic images (with the WARNING) and writes the file,
    the second loads it; /healthz reports int8 while each serves. The same
    model with random weights alone sits near the class tie, fails the 0.99
    gate and serves float32 with the WARNING; ``--no-int8`` serves float32."""
    import torch

    from weaklysuperviseddl_tpu_torch import cli

    health = []

    def one_request(server):
        health.append(MaskClient(f"http://127.0.0.1:{server.port}").healthz())
        server.stop()

    def model(shift):
        m = init_weights(DeepLabV3(2, 18, 0.25), torch.Generator().manual_seed(0))
        with torch.no_grad():
            m.classifier[4].bias[1] += shift
        return m

    monkeypatch.setattr(cli, "wait_for_interrupt", one_request)
    monkeypatch.setattr(cli, "serve_model", lambda smoke, checkpoint=None: model(10.0))
    state = tmp_path / "calib.json"
    args = ["serve", "--device", "cpu", "--size", "48", "--max-batch", "2", "--port", "0",
            "--calib-state", str(state)]
    assert cli.main(args) == 0
    out = capsys.readouterr().out
    assert "WARNING: --int8 with no --calib-dir" in out
    assert "calibrating int8 PTQ (synthetic, 2 images)" in out
    assert "int8/float mask agreement on calibration batch: 1.0000" in out
    assert json.loads(state.read_text())["n_targets"] == 28
    assert cli.main(args) == 0
    assert f"loading int8 calibration state from {state}" in capsys.readouterr().out
    assert cli.main(args[:-2] + ["--no-int8"]) == 0
    monkeypatch.setattr(cli, "serve_model", lambda smoke, checkpoint=None: model(0.0))
    assert cli.main(args[:-1] + [str(tmp_path / "random.json")]) == 0
    assert "< 0.99 on the calibration batch — falling back" in capsys.readouterr().out
    assert [h["int8"] for h in health] == [True, True, False, False]


def test_cli_client_reports_unreachable_server(capsys):
    from weaklysuperviseddl_tpu_torch.cli import main

    # port 9 on localhost (discard) has no MaskServer behind it
    assert main(["client", "--url", "http://127.0.0.1:9", "--stats"]) == 1
    assert "cannot reach" in capsys.readouterr().err
