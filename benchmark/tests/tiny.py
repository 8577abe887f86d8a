"""Cells cut to a size the CPU runs in seconds, for the harness's tests:
widths an eighth of the published ones, small images, few pets. The
published sizes run on the card only."""

from __future__ import annotations

from benchmark import harness

TINY = {
    "alternation": dict(config=dict(width_multiplier=0.125, image_size=64),
                        params=dict(store_size=40, image_size=48)),
    "serve": dict(config=dict(width_multiplier=0.125, image_size=64),
                  params=dict(photos=8, height=75, width=100, max_batch=4,
                              calibration_images=4, check_per_call=2)),
    "pseudo_masks": dict(config=dict(width_multiplier=0.125),
                         params=dict(pets=12, image_size=32, batch_size=4, check_per_pass=2)),
}


def cell(name: str) -> dict:
    c = harness.load_cell(name)
    cut = TINY[c["driver"]]
    c["config_spec"] = dict(c["config_spec"], **cut["config"])
    c["params"] = dict(c["params"], **cut["params"])
    if c["params"].get("crf"):
        c["params"]["crf"] = dict(c["params"]["crf"], bilat_sxy=8.0)
    return c


def run(name: str, seconds: float = 0.0, trace: bool = False, seed: int = 5):
    """(result, run) of one CPU run of the tiny cell."""
    import time

    import torch

    torch.manual_seed(0)
    return harness.run_cell(cell(name), seed, seconds, trace, "cpu", time.perf_counter())
