"""FC-only classifier training with a frozen backbone (port of
weaklysuperviseddl_tpu/train/classifier.py; ref
TraditionalModel/ClassificationModel.py:70-106).

Adam on the fc only, CrossEntropy over the breeds, per-epoch train loss and
accuracy plus validation accuracy and macro-F1. The backbone is frozen and
its BatchNorm in eval, so the pooled layer4 features are computed once per
image (the JAX package's ``cache_features=True``, what its pipeline runs) and
every epoch trains the fc on that cache, batch by batch in the loader's
order: the same updates as recomputing the backbone each epoch, which holds
for loaders that are epoch-deterministic. Padded rows (``pad_to_full``)
carry weight 0.

In a bfloat16 classifier the cached features are pooled in bfloat16 (what
the model's own forward feeds its fc) and each step's logits are the fc in
its compute dtype on the float32 parameters, JAX's ``_fc_logits``; the
weighted loss, the gradients and Adam's state are float32.
"""

from __future__ import annotations

import torch

from weaklysuperviseddl_tpu_torch.data.preprocess import preprocess_batch
from weaklysuperviseddl_tpu_torch.losses.basic import per_example_nll
from weaklysuperviseddl_tpu_torch.train.guard import Adam
from weaklysuperviseddl_tpu_torch.utils.metrics import classification_counts, finish_macro_f1


def _device(model) -> torch.device:
    return next(model.parameters()).device


@torch.no_grad()
def _batch_features(model, batch, image_size: int, interpolation: str):
    """One loader batch → (pooled layer4 features [B,C] in the model's compute
    dtype, labels [B], valid [B] float)."""
    dev = _device(model)
    x, _ = preprocess_batch(torch.from_numpy(batch.image).to(dev), None, size=image_size,
                            interpolation=interpolation)
    _, feats = model.features(x.permute(0, 3, 1, 2))
    pooled = feats["layer4"].mean(dim=(2, 3))
    labels = torch.from_numpy(batch.label).to(dev).long()
    valid = (torch.arange(labels.shape[0], device=dev) < batch.num_valid).float()
    return pooled, labels, valid


def _pooled_features(model, loader, image_size: int, interpolation: str):
    """One frozen-backbone pass: a list of per-batch (features, labels, valid)."""
    return [_batch_features(model, b, image_size, interpolation) for b in loader]


def _fc_step(model, opt, feats, labels, valid):
    """One Adam step on the fc; returns (Σ weighted loss, Σ weighted correct, Σ weights)."""
    with torch.enable_grad():
        logits = model.fc(feats)
        nll = per_example_nll(logits, labels)
        loss = (nll * valid).sum() / valid.sum().clamp(min=1.0)
        opt.zero_grad()
        loss.backward()
    opt.step()
    correct = ((logits.argmax(dim=1) == labels).float() * valid).sum()
    return loss.detach() * valid.sum(), correct.detach(), valid.sum()


def _val_counts(model, val, num_classes: int):
    with torch.no_grad():
        counts = None
        for feats, labels, valid in val:
            preds = model.fc(feats).argmax(dim=1)
            c = classification_counts(preds, labels, num_classes, valid=valid > 0)
            counts = c if counts is None else {k: counts[k] + c[k] for k in c}
    return counts


def train_fc_only(model, train_loader_fn, val_loader_fn=None, epochs: int = 10,
                  lr: float = 1e-3, num_classes: int = 37, image_size: int = 224,
                  interpolation: str = "bilinear", log=print):
    """Epoch loop with the reference's printout (ClassificationModel.py:98-104).
    ``*_loader_fn()`` returns an iterator of Batch objects; it is drained
    once. Trains ``model.fc`` in place and returns the model."""
    model.eval()
    for p in model.parameters():
        p.requires_grad_(False)
    model.fc.weight.requires_grad_(True)
    model.fc.bias.requires_grad_(True)
    opt = Adam([model.fc.weight, model.fc.bias], lr=lr)
    train = _pooled_features(model, train_loader_fn(), image_size, interpolation)
    val = None
    if val_loader_fn is not None:
        val = _pooled_features(model, val_loader_fn(), image_size, interpolation)

    for epoch in range(epochs):
        stats = torch.zeros(3, device=_device(model))
        for feats, labels, valid in train:
            stats += torch.stack(_fc_step(model, opt, feats, labels, valid))
        total_loss, correct, total = (float(v) for v in stats)
        log(f"Epoch {epoch + 1}/{epochs} - Train Loss: {total_loss / total:.4f}"
            f" - Train Acc: {100 * correct / total:.2f}%")
        if val is not None:
            accuracy, macro_f1 = (float(v) for v in finish_macro_f1(
                _val_counts(model, val, num_classes)))
            log(f"Evaluation - Accuracy: {accuracy:.2f}% - F1 Score (macro): {macro_f1:.4f}")
            log(f"           --> Val Acc: {accuracy:.2f}% - Val F1: {macro_f1:.4f}")
    model.fc.weight.requires_grad_(False)
    model.fc.bias.requires_grad_(False)
    return model


@torch.no_grad()
def evaluate_classification(model, loader, num_classes: int = 37, image_size: int = 224,
                            interpolation: str = "bilinear", log=print):
    """Accuracy (%) + macro-F1 from accumulated per-class counters
    (ref ClassificationModel.py:109-150)."""
    model.eval()
    dev = _device(model)
    counts = None
    for batch in loader:
        x, _ = preprocess_batch(torch.from_numpy(batch.image).to(dev), None, size=image_size,
                                interpolation=interpolation)
        logits, _ = model(x.permute(0, 3, 1, 2))
        labels = torch.from_numpy(batch.label).to(dev).long()
        valid = torch.arange(labels.shape[0], device=dev) < batch.num_valid
        c = classification_counts(logits.argmax(dim=1), labels, num_classes, valid=valid)
        counts = c if counts is None else {k: counts[k] + c[k] for k in c}
    accuracy, macro_f1 = (float(v) for v in finish_macro_f1(counts))
    log(f"Evaluation - Accuracy: {accuracy:.2f}% - F1 Score (macro): {macro_f1:.4f}")
    return accuracy, macro_f1
