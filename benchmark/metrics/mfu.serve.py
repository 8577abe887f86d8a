"""The served model's share of the card's int8 peak (1,979 TOP/s): the
float model's convolution operations an image (``counts.conv_gflop``, the
int8 program runs the same products) times the images of the window's
calls, over their time."""

import torch

from benchmark import counts, readings
from benchmark.models import reference_model


def read(run):
    if not run.params["int8"]:
        return None
    size = run.config["image_size"]
    model = reference_model(run.config, "meta")
    per_image = counts.conv_gflop(model, torch.empty((1, 3, size, size), device="meta"))
    return readings.mfu(run, per_image * run.params["photos"], counts.INT8_OPS_PER_S)
