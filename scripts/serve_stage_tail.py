"""Where ``MaskServer``'s request tail goes: its stages under closed-loop load.

    python scripts/serve_stage_tail.py [--clients 4] [--requests 1024] [--warm 4] \
        [--trace DIR] [--out FILE] [--smoke --device cpu]

The CLI's served model (``cli.serve_model``: DeepLabV3-ResNet50 at output
stride 8, 2 classes, seeded random weights), quantized to int8 on 64
synthetic pets (``data/synthetic.py``, as ``serve`` without ``--calib-dir``)
and warmed at every bucket; ``Predictor(max_batch=64, clean=True,
packed=True)`` behind ``MaskServer(max_wait_ms=5)``. ``--clients`` threads
each send their next synthetic 256² pet when the last reply came back (a
closed loop; ``chip_smoke.py``'s server phase runs 4), after ``--warm``
requests each that the numbers leave out. Prints one JSON
object: the server's ``/stats`` after the run, the clients' own p50 and p99,
and for the slowest 1% of requests (by the server's accept-to-wake
latency) each stage's mean ms and the stage that was the longest in each.
``--trace DIR`` then runs 128 more under
``profiling.trace(DIR)`` and adds its ``spans.json``. ``--smoke`` serves the
CLI's tiny model at 48² and batch 2, for a run on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
from collections import Counter

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def pets(n: int, size: int, seed: int) -> np.ndarray:
    from weaklysuperviseddl_tpu_torch.data.synthetic import synthetic_pet_arrays

    images, _, _ = synthetic_pet_arrays(n, size, seed=seed)
    return (images * 255).astype(np.uint8)


def closed_loop(port: int, images: np.ndarray, clients: int) -> list[float]:
    """Each client sends its share of ``images`` one after another; returns
    every request's seconds as the client saw them."""
    from weaklysuperviseddl_tpu_torch.pipelines.serve import MaskClient

    seconds, errors = [], []

    def client(k):
        c = MaskClient(f"http://127.0.0.1:{port}", timeout=120.0)
        try:
            for i in range(k, len(images), clients):
                t0 = time.perf_counter()
                c.predict(images[i])
                seconds.append(time.perf_counter() - t0)
        except Exception as e:  # reported below; the run fails
            errors.append(repr(e))
        finally:
            c.close()

    threads = [threading.Thread(target=client, args=(k,)) for k in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if errors or len(seconds) != len(images):
        raise RuntimeError(f"{len(seconds)} of {len(images)} replies; errors {errors[:3]}")
    return seconds


def tail(stage_s: list[tuple], stages: tuple) -> dict:
    """The slowest 1% of requests by accept-to-wake latency (every stage but
    ``respond``): each stage's mean ms, and how often each stage was the
    longest."""
    rows = np.asarray(stage_s) * 1e3
    latency = rows[:, :-1].sum(axis=1)
    k = max(1, round(len(rows) / 100))
    slow = rows[np.argsort(latency)[-k:]]
    return {"requests": k, "latency_ms_from": float(np.sort(latency)[-k]),
            "mean_ms": {s: float(v) for s, v in zip(stages, slow.mean(axis=0))},
            "longest": dict(Counter(stages[i] for i in slow.argmax(axis=1)))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--requests", type=int, default=1024)
    ap.add_argument("--warm", type=int, default=4,
                    help="requests a client sends first, left out of the numbers (0: cold)")
    ap.add_argument("--trace", default=None, help="directory for trace.json and spans.json")
    ap.add_argument("--out", default=None, help="also write the JSON object here")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    import torch

    from weaklysuperviseddl_tpu_torch.cli import serve_model
    from weaklysuperviseddl_tpu_torch.pipelines.serve import MaskClient, MaskServer, Predictor
    from weaklysuperviseddl_tpu_torch.utils import profiling

    size, max_batch = (48, 2) if args.smoke else (256, 64)
    pred = Predictor(serve_model(args.smoke), size=size, max_batch=max_batch, clean=True,
                     packed=True, device=args.device)
    pred.quantize(pets(max_batch, size, seed=0))
    pred.warmup(all_buckets=True)
    images = pets(args.requests, size, seed=1)
    server = MaskServer(pred, max_wait_ms=5.0).start()
    try:
        if args.warm:                     # the connections and the handler threads
            closed_loop(server.port, images[: args.warm * args.clients], args.clients)
            server.stage_s.clear()
            server.latencies_s.clear()
        t0 = time.perf_counter()
        client_s = closed_loop(server.port, images, args.clients)
        wall = time.perf_counter() - t0
        stats = MaskClient(f"http://127.0.0.1:{server.port}").stats()
        stage_s = list(server.stage_s)
        out = {"device": (torch.cuda.get_device_name(pred.device)
                          if pred.device.type == "cuda" else "cpu"),
               "clients": args.clients, "requests": len(images), "warm": args.warm,
               "size": size,
               "max_batch": max_batch, "int8": pred.quantized is not None,
               "img_per_s": len(images) / wall,
               "client_p50_ms": float(np.percentile(client_s, 50) * 1e3),
               "client_p99_ms": float(np.percentile(client_s, 99) * 1e3),
               "stats": stats, "tail_1pct": tail(stage_s, MaskServer.STAGES)}
        if args.trace:
            with profiling.trace(args.trace):
                closed_loop(server.port, images[:128], args.clients)
            with open(os.path.join(args.trace, "spans.json")) as f:
                out["traced"] = json.load(f)
    finally:
        server.stop()
    text = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
