"""The whole round's share of the card's float32 peak (67 TFLOP/s): the
convolutions of every training step (forward and backward) and of every
sweep forward, and K1's operations, counted from shapes, over the window."""

import torch

from benchmark import counts, readings
from benchmark.models import reference_model


def read(run):
    if not run.units:
        return None
    b, size = run.extra["batch"], run.config["image_size"]
    model = reference_model(run.config, "meta")
    x = torch.empty((b, 3, size, size), device="meta")
    step = counts.conv_gflop(model, x, backward=True)
    fwd = counts.conv_gflop(model, x, backward=False)
    rp = run.params["refine"]
    _, k1 = counts.refine_work(b, size, size, run.config["num_classes"], rp["window_size"],
                               rp["num_steps"], rp["loss"])
    per_round = (run.extra["steps_per_round"] * step
                 + run.extra["sweep_batches_per_round"] * (fwd + k1 / 1e9))
    return readings.mfu(run, per_round)
