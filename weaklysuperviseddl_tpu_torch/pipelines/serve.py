"""Serving path: raw uint8 image batch → binary masks, on the card.

Port of weaklysuperviseddl_tpu/pipelines/serve.py. One forward pass per batch:
uint8 → /255 → resize → ImageNet normalisation → DeepLabV3 → argmax →
(optional) largest-component cleanup, which launches the connected-components
kernel (``ops/cc.py``) on a CUDA tensor → (optional) bit-packing.

``Predictor`` pads ragged requests to power-of-two buckets, and dispatches
asynchronously: the upload leaves pinned host memory with a ``non_blocking``
copy, the forward pass is enqueued on the current stream, and the result is
copied back into pinned host memory with a ``non_blocking`` copy followed by
an event; ``readback`` waits on that event. Nothing in the dispatch waits for
the card, so a caller overlaps the next dispatch with the device's work.

``Predictor.quantize`` swaps the model for its int8 rewrite (``ops/quant.py``,
JAX's int8 PTQ: its sites, scales and calibration file), calibrated on images
or loaded from a calibration file of either package; the rest of the program
is unchanged.

``MaskServer`` and ``MaskClient`` carry the reference's HTTP protocol over
unchanged. Not ported yet: mesh serving (``Predictor(mesh=...)``).
"""

from __future__ import annotations

import io

import numpy as np
import torch

from weaklysuperviseddl_tpu_torch.data.preprocess import preprocess_images
from weaklysuperviseddl_tpu_torch.device import resolve_device
from weaklysuperviseddl_tpu_torch.masks.components import keep_largest_batch
from weaklysuperviseddl_tpu_torch.train.segmentation import _normalize_images

_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


def pack_binary_masks(masks: torch.Tensor) -> torch.Tensor:
    """[..., W] uint8 {0,1} → [..., W//8] uint8 bitmap (np.unpackbits layout,
    bitorder='big'): binary masks cross the device→host link 8x smaller."""
    w = masks.shape[-1]
    if w % 8:
        raise ValueError(f"width {w} not divisible by 8")
    bits = masks.reshape(*masks.shape[:-1], w // 8, 8).to(torch.uint8)
    weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8, device=masks.device)
    return (bits * weights).sum(dim=-1, dtype=torch.uint8)


def model_inputs(images_uint8: torch.Tensor, size: int) -> torch.Tensor:
    """[B,h,w,3] uint8 → the model's input [B,3,size,size]: /255, resize,
    ImageNet normalisation."""
    x = preprocess_images(images_uint8.permute(0, 3, 1, 2), size)
    return _normalize_images(x, channel_dim=1)


@torch.inference_mode()
def predict_masks(model, images_uint8: torch.Tensor, size: int = 256, clean: bool = False,
                  pack: bool = False) -> torch.Tensor:
    """[B,h,w,3] uint8 → uint8 {0,1} masks [B,size,size] on the images' device
    (``pack=True`` → [B,size,size//8] bitmaps). The model is in eval mode."""
    logits = model(model_inputs(images_uint8, size))
    masks = logits.argmax(dim=1).to(torch.uint8)
    if clean:
        masks = keep_largest_batch(masks)
    return pack_binary_masks(masks) if pack else masks


class Predictor:
    """Bucketed-batch server front over an eval-mode segmentation model.

    Ragged requests pad (by repeating the last image) up to the next power of
    two, capped at ``max_batch``, so a small fixed set of batch shapes covers
    every request size. Runs on ``device`` (default: the card; raises when
    there is none).

    Numerics: batches of different sizes may pick different convolution
    algorithms, so pixels whose two class logits tie to the last ulp can flip
    across bucket sizes (random-init weights sit closest to such ties);
    identical inputs through the same bucket are deterministic.

    ``quantized`` is the int8 model that serves in place of ``model`` once
    ``quantize`` has run (None: the float model serves)."""

    def __init__(self, model: torch.nn.Module, size: int = 256, max_batch: int = 16,
                 clean: bool = False, packed: bool = False, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.size = size
        self.max_batch = max_batch
        self.clean = clean
        self.packed = packed  # bit-pack masks on the device, unpack on the host
        self.quantized = None  # set by quantize()
        if packed:
            nc = getattr(model, "num_classes", 2)
            if nc != 2:
                raise ValueError(
                    f"packed=True is a BINARY-mask wire format; model has {nc} classes "
                    "(class ids >= 2 cannot round-trip a bitmap)")

    def _bucket(self, n: int) -> int:
        """Smallest serving bucket >= n: powers of two up to max_batch, plus
        max_batch itself."""
        return min(1 << max(0, n - 1).bit_length(), self.max_batch)

    def buckets(self) -> list[int]:
        return sorted({self._bucket(2**i) for i in range(self.max_batch.bit_length() + 1)
                       if 2**i <= self.max_batch} | {self.max_batch})

    def warmup(self, input_hw: tuple[int, int] | None = None, all_buckets: bool = False):
        """Run each serving batch shape once (``all_buckets=True``: every
        bucket, else max_batch), so cuDNN's plans and the kernels' build are
        paid before latency-sensitive load."""
        h, w = input_hw or (self.size, self.size)
        for b in self.buckets() if all_buckets else [self.max_batch]:
            self.readback(*self.dispatch_async(np.zeros((b, h, w, 3), np.uint8)))
        return self

    def quantize(self, calibration_images: np.ndarray | None = None, clip_ratio: float = 1.0,
                 state_path: str | None = None):
        """Serve the int8 rewrite of the model (``ops/quant.py``) from now on.
        ``calibration_images``: uint8 [N,h,w,3], N ≥ 1, observed in
        ``max_batch`` windows (a ragged tail is filled by tiling, so that
        every image is observed).

        ``state_path``: a calibration file (JSON, JAX's format). If it exists
        it is loaded and checked against this model's sites, and no image is
        needed; otherwise the calibration from the images is written there
        (atomically: a temporary file, then ``os.replace``). Returns the
        ``QuantReport``."""
        import json
        import os

        from weaklysuperviseddl_tpu_torch.ops.quant import Int8Quantizer

        def inputs(images: np.ndarray) -> torch.Tensor:
            return model_inputs(torch.from_numpy(np.ascontiguousarray(images, np.uint8))
                                .to(self.device), self.size)

        if state_path and os.path.exists(state_path):
            q = Int8Quantizer(self.model, inputs(
                np.zeros((self.max_batch, self.size, self.size, 3), np.uint8)))
            with open(state_path) as f:
                q.load_calibration(json.load(f))
        else:
            if calibration_images is None:
                raise ValueError("quantize() needs calibration_images when state_path is "
                                 "unset or does not exist yet")
            imgs = np.asarray(calibration_images)
            n = imgs.shape[0]
            total = -(-n // self.max_batch) * self.max_batch
            if total != n:
                imgs = np.concatenate([imgs] * -(-total // n))[:total]
            q = Int8Quantizer(self.model, inputs(imgs[:self.max_batch]))
            for i in range(0, imgs.shape[0], self.max_batch):
                q.observe(inputs(imgs[i:i + self.max_batch]))
            if state_path:
                tmp = state_path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(q.calibration_state(), f)
                os.replace(tmp, state_path)
        self.quantized, report = q.build(clip_ratio=clip_ratio)
        return report

    def _dispatch(self, images: torch.Tensor):
        """Enqueue one bucket-sized batch; returns (host tensor, event or None)."""
        model = self.model if self.quantized is None else self.quantized
        if self.device.type != "cuda":
            return predict_masks(model, images, self.size, self.clean, self.packed), None
        with torch.cuda.device(self.device):
            x = images.pin_memory().to(self.device, non_blocking=True)
            out = predict_masks(model, x, self.size, self.clean, self.packed)
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        return host, done

    def dispatch_async(self, images: np.ndarray):
        """Pad to the serving bucket and dispatch WITHOUT waiting: returns
        ``(pending_result, n)`` for ``readback``."""
        n = images.shape[0]
        if n > self.max_batch:
            raise ValueError(f"batch {n} exceeds max_batch {self.max_batch}")
        bucket = self._bucket(n)
        if n < bucket:
            images = np.concatenate([images, np.repeat(images[-1:], bucket - n, axis=0)])
        return self._dispatch(torch.from_numpy(np.ascontiguousarray(images, np.uint8))), n

    def readback(self, pending, n: int) -> np.ndarray:
        """Wait for a ``dispatch_async`` result; unpack bitmaps and strip the
        bucket padding."""
        host, done = pending
        if done is not None:
            done.synchronize()
        out = host.numpy()[:n]
        return np.unpackbits(out, axis=-1) if self.packed else out.copy()

    def __call__(self, images: np.ndarray) -> np.ndarray:
        return self.readback(*self.dispatch_async(images))

    def serve_http(self, host: str = "127.0.0.1", port: int = 0, max_wait_ms: float = 5.0,
                   **server_kwargs) -> "MaskServer":
        """Start an HTTP front for this predictor (returns a started
        MaskServer; .port, .stop()). ``server_kwargs`` go to MaskServer."""
        server = MaskServer(self, host=host, port=port, max_wait_ms=max_wait_ms,
                            **server_kwargs)
        server.start()
        return server

    def predict_many(self, images: np.ndarray, in_flight: int = 4) -> np.ndarray:
        """Throughput path for [N,h,w,3] uint8, N unbounded: ``max_batch``
        chunks with up to ``in_flight`` dispatches pending before each
        blocking readback, so the card computes chunk i while the host uploads
        chunk i+1 and reads back chunk i-k."""
        from collections import deque

        n = images.shape[0]
        out = None
        pending: deque = deque()  # (start, pending result, count)

        def drain_one():
            nonlocal out
            s0, dev, c0 = pending.popleft()
            host = self.readback(dev, c0)
            if out is None:
                out = np.empty((n,) + host.shape[1:], host.dtype)
            out[s0 : s0 + c0] = host

        for s in range(0, n, self.max_batch):
            dev, c = self.dispatch_async(images[s : s + self.max_batch])
            pending.append((s, dev, c))
            if len(pending) > in_flight:
                drain_one()
        while pending:
            drain_one()
        return out


class MaskServer:
    """HTTP front with dynamic micro-batching (the reference's protocol).

    POST /predict with an ``np.save``-serialised uint8 [h,w,3] body → 200 with
    an ``np.save``-serialised uint8 {0,1} [size,size] mask. A request with
    ``Content-Type: image/*`` is decoded with PIL, and ``Accept: image/png``
    returns a 1-bit PNG mask; PIL is imported only for those, so the npy wire
    works without it. Malformed bodies get 400, unknown paths 404.
    GET /healthz → readiness JSON; GET /stats → cumulative counters and
    request latency p50/p90/p99 over a 4096-request ring buffer.

    Requests arriving within ``max_wait_ms`` of each other coalesce into one
    dispatch (up to ``predictor.max_batch``); same-shape requests batch
    together, mixed shapes go as separate groups in arrival order. A dispatch
    thread owns the device and keeps up to ``in_flight`` asynchronous
    dispatches pending; a drain thread blocks on readbacks and completes
    requests. While the in-flight queue is full the dispatcher keeps
    coalescing past the window, so batches grow when the device is the
    bottleneck.

    Overload protection: the request queue is bounded at ``max_queue`` (a
    full queue sheds 503 + Retry-After); Content-Length over
    ``max_body_bytes`` or negative gets 413 before the body is read; an
    accepted request waits at most ``request_timeout_s`` (then 504).
    """

    def __init__(self, predictor, host: str = "127.0.0.1", port: int = 0,
                 max_wait_ms: float = 5.0, in_flight: int = 4, max_queue: int = 256,
                 max_body_bytes: int = 32 << 20, request_timeout_s: float = 60.0):
        import threading
        from collections import deque

        self.predictor = predictor
        self.host = host
        self._port = port
        self.max_wait_ms = max_wait_ms
        self.in_flight = in_flight
        self.max_queue = max_queue
        self.max_body_bytes = max_body_bytes
        self.request_timeout_s = request_timeout_s
        self._server = None
        self._threads = []
        self._queue = None
        # per-dispatch coalesced batch sizes, bounded
        self.dispatch_sizes: deque[int] = deque(maxlen=65536)
        # cumulative counters for GET /stats; handler threads and the worker
        # both write, so they are guarded by a lock
        self.total_requests = 0
        self.total_dispatches = 0
        self.total_images = 0
        self.total_shed = 0        # 503: request queue full
        self.total_rejected = 0    # 413: body over max_body_bytes
        self.total_timeouts = 0    # 504: result not ready in request_timeout_s
        self._stats_lock = threading.Lock()
        self._started_at = None
        # per-request wall latency (accept → result ready) of successful
        # requests, seconds; ring buffer
        self.latencies_s: deque[float] = deque(maxlen=4096)

    def drain_dispatch_sizes(self) -> list[int]:
        """Return and clear the recorded per-dispatch batch sizes."""
        sizes = list(self.dispatch_sizes)
        self.dispatch_sizes.clear()
        return sizes

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self):
        import queue
        import threading
        import time
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        pred = self.predictor
        q = self._queue = queue.Queue(maxsize=self.max_queue)
        inflight = queue.Queue(maxsize=self.in_flight)
        max_wait_s = self.max_wait_ms / 1e3
        dispatch_sizes = self.dispatch_sizes
        server = self
        self._started_at = time.monotonic()

        class _Job:
            __slots__ = ("img", "event", "result", "error")

            def __init__(self, img):
                self.img = img
                self.event = threading.Event()
                self.result = None
                self.error = None

        def dispatcher():
            # Owns the device: coalesces, dispatches asynchronously, hands
            # (chunk, pending result) to the drain thread. The bounded
            # in-flight queue is the backpressure.
            stopping = False
            while not stopping:
                job = q.get()
                if job is None:
                    break
                batch = [job]
                deadline = time.monotonic() + max_wait_s
                while len(batch) < pred.max_batch:
                    now = time.monotonic()
                    if now >= deadline and not inflight.full():
                        break
                    # adaptive window: past the deadline a dispatch would
                    # block on the full in-flight queue anyway, so keep
                    # coalescing instead
                    try:
                        nxt = q.get(timeout=(deadline - now) if now < deadline else 0.005)
                    except queue.Empty:
                        # re-check with a fresh clock: a get that timed out at
                        # the deadline must fall into the adaptive window
                        if inflight.full() and time.monotonic() >= deadline:
                            continue
                        break
                    if nxt is None:
                        # finish this batch, then exit (a re-put could
                        # deadlock against a full bounded queue)
                        stopping = True
                        break
                    batch.append(nxt)
                groups = {}
                for b in batch:
                    groups.setdefault(b.img.shape, []).append(b)
                for jobs in groups.values():
                    for s in range(0, len(jobs), pred.max_batch):
                        chunk = jobs[s : s + pred.max_batch]
                        dispatch_sizes.append(len(chunk))
                        with server._stats_lock:
                            server.total_dispatches += 1
                            server.total_images += len(chunk)
                        try:
                            dev, n = pred.dispatch_async(np.stack([b.img for b in chunk]))
                        except Exception as e:  # surface as 500, keep serving
                            for b in chunk:
                                b.error = e
                                b.event.set()
                            continue
                        inflight.put((chunk, dev, n))
            inflight.put(None)

        def drainer():
            # Blocks on readbacks and completes requests, so the dispatcher's
            # next coalesce window opens while the device computes.
            while True:
                item = inflight.get()
                if item is None:
                    return
                chunk, dev, n = item
                try:
                    masks = pred.readback(dev, n)
                    for b, m in zip(chunk, masks):
                        b.result = m
                except Exception as e:  # surface as 500, keep serving
                    for b in chunk:
                        b.error = e
                for b in chunk:
                    b.event.set()

        class Handler(BaseHTTPRequestHandler):
            # HTTP/1.1 keep-alive: every response sets Content-Length
            protocol_version = "HTTP/1.1"
            timeout = 60

            def _send(self, status: int, ctype: str, body: bytes, headers=()):
                self.send_response(status)
                for k, v in headers:
                    self.send_header(k, v)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                import json

                if self.path == "/healthz":
                    body = {
                        "status": "ok",
                        "size": pred.size,
                        "max_batch": pred.max_batch,
                        "buckets": pred.buckets(),
                        "int8": pred.quantized is not None,
                        "packed": pred.packed,
                    }
                elif self.path == "/stats":
                    with server._stats_lock:
                        n_req, n_disp, n_img = (server.total_requests, server.total_dispatches,
                                                server.total_images)
                        n_shed, n_rej, n_to = (server.total_shed, server.total_rejected,
                                               server.total_timeouts)
                    lat = list(server.latencies_s)
                    body = {
                        "total_requests": n_req,
                        "total_dispatches": n_disp,
                        "total_images": n_img,
                        "total_shed_503": n_shed,
                        "total_rejected_413": n_rej,
                        "total_timeouts_504": n_to,
                        "queue_depth": q.qsize(),
                        "mean_dispatch_size": n_img / n_disp if n_disp else 0.0,
                        "uptime_s": round(time.monotonic() - server._started_at, 3),
                    }
                    if lat:
                        ms = np.percentile(np.asarray(lat) * 1e3, [50, 90, 99])
                        body.update({
                            "latency_window": len(lat),
                            "latency_p50_ms": round(float(ms[0]), 1),
                            "latency_p90_ms": round(float(ms[1]), 1),
                            "latency_p99_ms": round(float(ms[2]), 1),
                        })
                else:
                    self.send_error(404, "GET /healthz or /stats")
                    return
                self._send(200, "application/json", json.dumps(body).encode())

            def do_POST(self):
                if self.path != "/predict":
                    self.send_error(404, "POST /predict")
                    return
                with server._stats_lock:
                    server.total_requests += 1
                t_accept = time.monotonic()
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    if n < 0 or n > server.max_body_bytes:
                        # reject before reading: a negative length would be an
                        # unbounded read-to-EOF
                        with server._stats_lock:
                            server.total_rejected += 1
                        self.send_error(413, f"body {n} bytes exceeds cap {server.max_body_bytes}")
                        return
                    raw = self.rfile.read(n)
                    ctype = (self.headers.get("Content-Type")
                             or "application/octet-stream").split(";")[0].strip()
                    if ctype.startswith("image/"):
                        from PIL import Image

                        img = np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"), np.uint8)
                    else:
                        img = np.load(io.BytesIO(raw), allow_pickle=False)
                    if img.ndim != 3 or img.shape[-1] != 3 or img.dtype != np.uint8:
                        raise ValueError(f"expected uint8 [h,w,3], got {img.dtype} {img.shape}")
                except Exception:
                    self.send_error(400, "body must be np.save of uint8 [h,w,3], or a "
                                         "PNG/JPEG with Content-Type: image/*")
                    return
                job = _Job(img)
                try:
                    q.put_nowait(job)
                except queue.Full:
                    with server._stats_lock:
                        server.total_shed += 1
                    self._send(503, "text/plain", b"server overloaded, retry\n",
                               headers=(("Retry-After", "1"),))
                    return
                if not job.event.wait(server.request_timeout_s):
                    with server._stats_lock:
                        server.total_timeouts += 1
                    self.send_error(504, f"no result in {server.request_timeout_s}s")
                    return
                if job.error is not None:
                    self.send_error(500, str(job.error))
                    return
                # only successful requests enter the latency percentiles
                server.latencies_s.append(time.monotonic() - t_accept)
                buf = io.BytesIO()
                if "image/png" in (self.headers.get("Accept") or "").lower():
                    from PIL import Image

                    Image.fromarray((job.result > 0).astype(np.uint8) * 255, "L").convert(
                        "1").save(buf, format="PNG")
                    out_type = "image/png"
                else:
                    np.save(buf, job.result)
                    out_type = "application/octet-stream"
                self._send(200, out_type, buf.getvalue())

            def log_message(self, *args):  # quiet: the server is a library
                pass

        class _Server(ThreadingHTTPServer):
            request_queue_size = 128  # the stdlib's 5 resets bursts of connects

        self._server = _Server((self.host, self._port), Handler)
        for target in (dispatcher, drainer, self._server.serve_forever):
            t = threading.Thread(target=target, daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def stop(self):
        self._server.shutdown()
        self._server.server_close()  # release the listening socket now
        self._queue.put(None)
        for t in self._threads:
            t.join(timeout=5)


class MaskClient:
    """Stdlib-only client for the MaskServer protocol.

    ``wire="npy"`` POSTs ``np.save`` bodies and reads ``np.save`` masks;
    ``wire="png"`` sends PNG and asks for a 1-bit PNG mask (needs PIL). Both
    return the same uint8 {0,1} [size,size] mask. One keep-alive connection
    per instance, rebuilt once on a stale connection; HTTP errors raise
    ``urllib.error.HTTPError``. Not thread-safe: one client per thread.
    """

    def __init__(self, base_url: str, wire: str = "npy", timeout: float = 120.0):
        import urllib.parse

        if wire not in ("npy", "png"):
            raise ValueError(f"wire must be 'npy' or 'png', got {wire!r}")
        self.base_url = base_url.rstrip("/")
        self.wire = wire
        self.timeout = timeout
        self._conn = None
        u = urllib.parse.urlsplit(self.base_url)
        if u.scheme not in ("http", "https"):
            raise ValueError(f"base_url must be http(s)://…, got {base_url!r}")
        self._scheme = u.scheme
        self._netloc = u.netloc
        self._host = u.hostname
        self._port = u.port  # None → scheme default
        self._prefix = u.path.rstrip("/")  # reverse-proxy mount point

    def _request(self, method: str, path: str, body=None, headers: dict | None = None):
        """One request on the persistent connection → (headers, raw body).
        Raises HTTPError on status >= 400; retries once on a transport error."""
        import http.client
        import urllib.error

        path = self._prefix + path
        for attempt in (0, 1):
            try:
                if self._conn is None:
                    conn_cls = (http.client.HTTPSConnection if self._scheme == "https"
                                else http.client.HTTPConnection)
                    self._conn = conn_cls(self._host, self._port, timeout=self.timeout)
                self._conn.request(method, path, body=body, headers=headers or {})
                r = self._conn.getresponse()
                raw = r.read()  # drain fully so the connection is reusable
                if r.will_close:
                    self._conn.close()
                    self._conn = None
                if r.status >= 400:
                    raise urllib.error.HTTPError(f"{self._scheme}://{self._netloc}{path}",
                                                 r.status, r.reason, r.headers, io.BytesIO(raw))
                return r.headers, raw
            except urllib.error.HTTPError:
                raise
            except (http.client.HTTPException, OSError):
                if self._conn is not None:
                    self._conn.close()
                    self._conn = None
                if attempt:
                    raise

    def close(self):
        if self._conn is not None:
            self._conn.close()
            self._conn = None

    def _post(self, body: bytes, headers: dict) -> np.ndarray:
        rheaders, raw = self._request("POST", "/predict", body=body, headers=headers)
        if rheaders.get("Content-Type", "") == "image/png":
            from PIL import Image

            return (np.asarray(Image.open(io.BytesIO(raw)).convert("L")) > 0).astype(np.uint8)
        return np.load(io.BytesIO(raw), allow_pickle=False)

    def predict(self, image: np.ndarray) -> np.ndarray:
        """uint8 [h,w,3] image → uint8 {0,1} [size,size] mask."""
        img = np.ascontiguousarray(image, np.uint8)
        if img.ndim != 3 or img.shape[-1] != 3:
            raise ValueError(f"expected [h,w,3], got {img.shape}")
        buf = io.BytesIO()
        if self.wire == "png":
            from PIL import Image

            Image.fromarray(img).save(buf, format="PNG")
            headers = {"Content-Type": "image/png", "Accept": "image/png"}
        else:
            np.save(buf, img)
            headers = {}
        return self._post(buf.getvalue(), headers)

    def predict_file(self, path: str) -> np.ndarray:
        """Send an on-disk PNG/JPEG as is; the server decodes it."""
        import mimetypes

        ctype = mimetypes.guess_type(path)[0] or "image/png"
        if not ctype.startswith("image/"):
            raise ValueError(f"{path}: not an image ({ctype})")
        with open(path, "rb") as f:
            body = f.read()
        headers = {"Content-Type": ctype}
        if self.wire == "png":
            headers["Accept"] = "image/png"
        return self._post(body, headers)

    def _get_json(self, path: str) -> dict:
        import json

        _, raw = self._request("GET", path)
        return json.loads(raw)

    def healthz(self) -> dict:
        return self._get_json("/healthz")

    def stats(self) -> dict:
        return self._get_json("/stats")
