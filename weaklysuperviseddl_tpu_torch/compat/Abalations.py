"""Reference surface: TraditionalModel/Abalations.py, the file name's typo
kept (port of weaklysuperviseddl_tpu/compat/Abalations.py).

The reference's grid driver with its call defects repaired to their evident
intent, as in the JAX package: ``run_ablation`` takes the classifier and the
loaders it needs; the grid is LayerCAM × thresholds × alphas × lrs ×
keep-largest, 3 repeats, with mean and standard-deviation summaries.
"""

from __future__ import annotations

import os

import torch

from weaklysuperviseddl_tpu_torch.config import ExperimentConfig, smoke_config
from weaklysuperviseddl_tpu_torch.device import resolve_device
from weaklysuperviseddl_tpu_torch.pipelines.ablations import default_grid
from weaklysuperviseddl_tpu_torch.pipelines.ablations import run_ablation as _run_ablation
from weaklysuperviseddl_tpu_torch.pipelines.ablations import (
    run_ablation_experiment as _run_experiment,
)


def run_ablation(classifier, save_path, loader, test_loader, cam_method, cam_thresh, alpha,
                 lr, keep_largest, run_id, cfg: ExperimentConfig | None = None, log=print):
    """Reference signature (Abalations.py:9-29). ``classifier``: a compat
    ``FrozenResNetCAM``; the ``.pth`` at ``save_path`` is loaded into it
    where it exists (``torch.load``, the reference's keys or torchvision's).
    ``test_loader``: a zero-argument factory of Batch iterators."""
    if save_path and os.path.exists(save_path):
        classifier.load_state_dict(torch.load(save_path, map_location="cpu", weights_only=True))
    return _run_ablation(classifier, train_loader=loader, test_loader=test_loader,
                         cam_method=cam_method, cam_thresh=cam_thresh, alpha=alpha, lr=lr,
                         keep_largest=keep_largest, run_id=run_id,
                         cfg=cfg or ExperimentConfig(), log=log)


def run_abalation_experiment(all_combinations, classifier=None,
                             cfg: ExperimentConfig | None = None, num_repeats: int = 3,
                             log=print, device=None):
    """Reference signature (Abalations.py:32-81), the typo'd name kept.
    Without a ``classifier``, the config's seeded one on ``device`` (None:
    the card)."""
    cfg = cfg or smoke_config()
    if classifier is None:
        from weaklysuperviseddl_tpu_torch.pipelines.weakly import build_classifier

        classifier = build_classifier(cfg, resolve_device(device))
    return _run_experiment(all_combinations, classifier, cfg, num_repeats=num_repeats, log=log)


run_ablation_experiment = run_abalation_experiment  # the name spelled right


def main(device=None):
    """The reference's grid (``pipelines.ablations.default_grid``)."""
    return run_abalation_experiment(default_grid(), device=device)


if __name__ == "__main__":
    main()
