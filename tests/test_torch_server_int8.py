"""The MaskServer round trip on the port's Predictor and the serve CLI in int8
with a calibration state (moved out of test_torch_server.py, whose helpers
they share by import, so that xdist starts these heavy tests after the long
JAX files)."""

import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from test_torch_server import _post_npy

from weaklysuperviseddl_tpu_torch.models.deeplabv3 import DeepLabV3
from weaklysuperviseddl_tpu_torch.models.resnet import init_weights
from weaklysuperviseddl_tpu_torch.pipelines.serve import MaskClient, Predictor


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

