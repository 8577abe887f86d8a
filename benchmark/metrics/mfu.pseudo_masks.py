"""The pass's share of the card's float32 peak (67 TFLOP/s): the
classifier's convolutions forward, the input gradients LayerCAM needs back
to layer3 (layer4's convolutions once more), and, with the CRF, K3's
operations (one normalisation and ``n_iters`` messages a batch), counted
from shapes, times the passes of the window, over their time."""

import torch

from benchmark import counts, readings
from benchmark.models import reference_model


def read(run):
    p, size, b = run.params, run.params["image_size"], run.extra["batch"]
    model = reference_model(run.config, "meta")
    x = torch.empty((b, 3, size, size), device="meta")
    per_batch = counts.conv_gflop(model, x) + counts.conv_gflop(model, x, within="layer4")
    crf = p.get("crf")
    if crf is not None:
        n, k = size * size, (-(-size // crf["key_stride"])) ** 2
        per_batch += (counts.bilateral_work(b, n, k, 5, 1)[1]
                      + crf["n_iters"] * counts.bilateral_work(b, n, k, 5, 2)[1]) / 1e9
    return readings.mfu(run, per_batch * run.extra["batches_per_pass"])
