"""Real-weights parity harness of the PyTorch port: the checks of
``scripts/parity_harness.py``, with its thresholds and report lines, run on
the port's models (``weaklysuperviseddl_tpu_torch``) against the same
PyTorch goldens on the same ``.pth`` bytes, and written to PARITY.md:

  * classifier .pth (the reference's ``classifier_weights*.pth``, stem
    ``layer0.0``/``layer0.1``, or a raw torchvision ``resnet50*.pth``): the
    port's ``CamClassifier`` logits against ``tests/torch_ref.TResNetCAM``
    (< 1e-2), and ``cam/layercam.py`` against a hook-based LayerCAM golden
    (mean < 5e-3; INDETERMINATE where the golden's raw CAMs are flat).
  * deeplabv3 .pth (torchvision ``deeplabv3_resnet50`` layout): the port's
    ``DeepLabV3`` logits against ``TDeepLabV3`` (< 5e-2), argmax agreement
    (> 0.999), and with 2 classes and Pet on disk the binary IoU/acc.
  * basnet.pth: ``pipelines/basnet_infer.build_basnet``, and with Pet on
    disk ``run_inference``'s IoU/acc protocol and the saliency MAE against a
    golden PNG directory.

Each check SKIPs loudly when its file is missing. Depth and width are read
from the state dict's shapes, so narrow checkpoints work too. The port runs
on ``--device`` (the card unless ``cpu``), the goldens on the CPU, TF32 off.

Usage:
  python -m weaklysuperviseddl_tpu_torch parity --weights-dir ./Weights
      [--pet-root ./data] [--basnet-golden-dir DIR] [--num-images 8]
      [--device cpu] [--out PARITY.md]
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import sys

import numpy as np

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

IMAGE_SIZE = 224
MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)


class Report:
    """The report's lines, printed as they come."""

    def __init__(self):
        self.lines: list[str] = []

    def __call__(self, line: str = ""):
        print(line, flush=True)
        self.lines.append(line)


def find_weights(weights_dir, patterns):
    for pat in patterns:
        hits = sorted(glob.glob(os.path.join(weights_dir, pat)))
        if hits:
            return hits[0]
    return None


def load_pth(path: str) -> dict:
    import torch

    return torch.load(path, map_location="cpu", weights_only=True)


def load_pet_images(pet_root, n, size=IMAGE_SIZE):
    """A few real Pet images and their trimaps (None where missing) from
    disk, resized to size², or None."""
    from PIL import Image

    img_dir = os.path.join(pet_root, "oxford-iiit-pet", "images")
    if not os.path.isdir(img_dir):
        img_dir = os.path.join(pet_root, "images")
    if not os.path.isdir(img_dir):
        return None
    files = sorted(glob.glob(os.path.join(img_dir, "*.jpg")))[:n]
    if not files:
        return None
    imgs, tris = [], []
    for f in files:
        img = Image.open(f).convert("RGB").resize((size, size), Image.BILINEAR)
        imgs.append(np.asarray(img, np.uint8))
        tri_f = f.replace("images", os.path.join("annotations", "trimaps")).replace(
            ".jpg", ".png")
        if os.path.exists(tri_f):
            tris.append(np.asarray(Image.open(tri_f).resize((size, size), Image.NEAREST),
                                   np.uint8))
        else:
            tris.append(None)
    return np.stack(imgs), tris


def normalize_classifier_keys(state: dict) -> dict:
    """The reference FrozenResNetCAM's stem (``layer0.0.``/``layer0.1.``,
    ClassificationModel.py:18) → torchvision's names; raw torchvision
    checkpoints pass through unchanged."""
    return {re.sub(r"^layer0\.1\.", "bn1.", re.sub(r"^layer0\.0\.", "conv1.", k)): v
            for k, v in state.items()}


def resnet_shape(state: dict, prefix: str = "") -> tuple[int, float]:
    """(depth, width multiplier) of a torchvision-layout ResNet from its
    state dict: the stem's channels are max(8, int(64·width)), layer3's
    blocks 2 at depth 18 and 6 at 34 and 50, whose bottlenecks have conv3."""
    stem = state[f"{prefix}conv1.weight"].shape[0]
    blocks = {int(m.group(1)) for k in state
              if (m := re.match(rf"^{re.escape(prefix)}layer3\.(\d+)\.", k))}
    if f"{prefix}layer1.0.conv3.weight" in state:
        depth = 50
    else:
        depth = 18 if len(blocks) == 2 else 34
    return depth, stem / 64


class TorchHookLayerCAM:
    """The LayerCAM golden: the reference's hook mechanism (LayerCAM.py:7-81
    semantics) on the torch mirror, a copy of ``tests/test_cam.py``'s."""

    def __init__(self, model, layers=("layer3", "layer4")):
        self.model = model.eval()
        self.layers = layers
        self.acts, self.grads = {}, {}
        for name in layers:
            mod = getattr(model, name)
            mod.register_forward_hook(self._fwd_hook(name))
            mod.register_full_backward_hook(self._bwd_hook(name))

    def _fwd_hook(self, name):
        def hook(module, inputs, output):
            self.acts[name] = output
        return hook

    def _bwd_hook(self, name):
        def hook(module, grad_in, grad_out):
            self.grads[name] = grad_out[0]
        return hook

    def generate(self, images, class_idx, alpha=1.0, mode="per_layer", out_size=64):
        import torch
        import torch.nn.functional as F

        self.acts.clear()
        self.grads.clear()
        images = images.requires_grad_()
        logits, _ = self.model(images)
        scores = logits.gather(1, class_idx.view(-1, 1)).squeeze(1)
        self.model.zero_grad()
        scores.backward(torch.ones_like(scores))

        layer_cams = []
        for name in self.layers:
            with torch.no_grad():
                cam = F.relu(self.grads[name] * self.acts[name]).sum(dim=1)
                cam = F.relu(cam)
                cam = cam - cam.flatten(1).min(1).values[:, None, None]
                cam = cam / (cam.flatten(1).max(1).values[:, None, None] + 1e-8)
                if mode == "per_layer":
                    cam = cam ** alpha
                    cam = cam - cam.flatten(1).min(1).values[:, None, None]
                    cam = cam / (cam.flatten(1).max(1).values[:, None, None] + 1e-8)
                cam = F.interpolate(cam.unsqueeze(1), size=(out_size, out_size),
                                    mode="bilinear", align_corners=False).squeeze(1)
                layer_cams.append(cam)
        final = sum(layer_cams) / len(layer_cams)
        if mode == "final":
            final = final.clamp(min=0.0) ** alpha
        return final.detach()


def port_classifier(state: dict, device):
    """The port's CamClassifier with ``state`` loaded, in eval mode."""
    from weaklysuperviseddl_tpu_torch.models.classifier import CamClassifier

    depth, width = resnet_shape(state)
    model = CamClassifier(num_classes=state["fc.weight"].shape[0], depth=depth,
                          width_multiplier=width)
    model.load_state_dict(state, strict=True)
    return model.to(device).eval()


def port_deeplab(state: dict, device):
    """The port's DeepLabV3 with ``state`` loaded, in eval mode."""
    from weaklysuperviseddl_tpu_torch.models.deeplabv3 import DeepLabV3

    depth, width = resnet_shape(state, "backbone.")
    model = DeepLabV3(num_classes=state["classifier.4.weight"].shape[0], backbone_depth=depth,
                      width_multiplier=width)
    model.load_state_dict(state, strict=True)
    return model.to(device).eval()


def check_classifier(report, path, images_u8, num_images, device):
    import torch
    import torch.nn.functional as F
    from torch_ref import TResNetCAM

    from weaklysuperviseddl_tpu_torch.cam.layercam import layercam

    report("## Classifier + LayerCAM")
    state = normalize_classifier_keys(load_pth(path))
    depth, width = resnet_shape(state)
    tmodel = TResNetCAM(depth=depth, num_classes=state["fc.weight"].shape[0], width=width)
    tmodel.load_state_dict(state)
    tmodel.eval()
    model = port_classifier(state, device)

    x = images_u8[:num_images].astype(np.float32) / 255.0
    xt = torch.from_numpy(x)
    with torch.no_grad():
        tlogits, _ = tmodel(xt.permute(0, 3, 1, 2))
        plogits, _ = model(xt.to(device).permute(0, 3, 1, 2))
    logit_mad = float((plogits.float().cpu() - tlogits).abs().max())
    report(f"- logits max-abs-diff over {len(x)} images: {logit_mad:.2e} "
           f"({'PASS' if logit_mad < 1e-2 else 'FAIL'})")

    cls = tlogits.argmax(1)
    hook_golden = TorchHookLayerCAM(tmodel)
    golden = hook_golden.generate(xt.permute(0, 3, 1, 2), cls, alpha=0.5, mode="per_layer",
                                  out_size=IMAGE_SIZE)
    cam, _ = layercam(model, xt.to(device), cls.to(device), alpha=0.5, alpha_mode="per_layer",
                      output_size=IMAGE_SIZE)
    diff = (cam.cpu() - golden).abs()

    # The per-layer min-max divides by the raw CAM's range: on untrained
    # weights the raw CAMs are nearly flat and the normalised maps amplify
    # conv rounding many times over (scripts/parity_harness.py).
    rel_range = min(
        float((raw.max() - raw.min()) / raw.abs().mean().clamp_min(1e-12))
        for raw in (F.relu(hook_golden.grads[n] * hook_golden.acts[n]).sum(1).detach()
                    for n in hook_golden.layers))
    mean = float(diff.mean())
    if mean < 5e-3:
        verdict = "PASS"
    elif rel_range < 0.25:
        verdict = (f"INDETERMINATE — raw CAM dynamic range is {rel_range:.2f} "
                   f"of its mean (degenerate/untrained weights); rerun with "
                   f"trained weights")
    else:
        verdict = "FAIL"
    report(f"- LayerCAM mean-abs-diff: {mean:.2e} (max {float(diff.max()):.2e}) ({verdict})")


def check_deeplab(report, path, images_u8, trimaps, num_images, device):
    import torch
    from torch_ref import TDeepLabV3

    report("## DeepLabV3")
    state = {k: v for k, v in load_pth(path).items() if not k.startswith("aux_classifier.")}
    depth, width = resnet_shape(state, "backbone.")
    if depth != 50:
        report(f"- SKIP: the golden (tests/torch_ref.TDeepLabV3) is ResNet-50 only, the "
               f"checkpoint's backbone is ResNet-{depth}")
        return
    num_classes = state["classifier.4.weight"].shape[0]
    tmodel = TDeepLabV3(num_classes=num_classes, width=width)
    tmodel.load_state_dict(state)
    tmodel.eval()
    model = port_deeplab(state, device)

    x = torch.from_numpy((images_u8[:num_images].astype(np.float32) / 255.0 - MEAN) / STD)
    with torch.no_grad():
        tlogits = tmodel(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        plogits = model.logits_nhwc(x.to(device)).cpu()
    mad = float((plogits - tlogits).abs().max())
    report(f"- logits max-abs-diff over {len(x)} images: {mad:.2e} "
           f"({'PASS' if mad < 5e-2 else 'FAIL'})")
    agree = float((plogits.argmax(-1) == tlogits.argmax(-1)).float().mean())
    report(f"- argmax-prediction agreement: {agree:.4f} "
           f"({'PASS' if agree > 0.999 else 'FAIL'})")

    if num_classes == 2 and any(t is not None for t in trimaps):
        ious, accs = [], []
        for p, t in zip(plogits.argmax(-1).numpy(), trimaps):
            if t is None:
                continue
            gt = (t == 1).astype(np.uint8)
            union = np.logical_or(p, gt).sum()
            ious.append(np.logical_and(p, gt).sum() / union if union else 1.0)
            accs.append((p == gt).mean())
        report(f"- Pet binary IoU {np.mean(ious):.4f}, acc {np.mean(accs):.4f} "
               f"(reference protocol SegmentationModel.py:126-159; compare to "
               f"the torch run of the same checkpoint, parity budget ±0.5 mIoU)")


def check_basnet(report, path, pet_root, golden_dir, num_images, device):
    import torch

    from weaklysuperviseddl_tpu_torch.data.dataset import download_data
    from weaklysuperviseddl_tpu_torch.pipelines.basnet_infer import (
        IMG_SIZE,
        build_basnet,
        run_inference,
        saliency_step,
    )

    report("## BASNet saliency")
    model = build_basnet(weights_path=path, device=device)
    report(f"- ingested {path} into the port's BASNet")

    data = load_pet_images(pet_root, num_images, size=IMG_SIZE) if pet_root else None
    if data is None:
        report("- SKIP image checks: no Pet images on disk")
        return
    _, mean_iou, mean_acc = run_inference(download_data(pet_root, split="test", limit=num_images),
                                          model, num_images=num_images, output_folder=None,
                                          log=lambda *_: None)
    report(f"- RunInference protocol (ref :124-126): mean IoU {mean_iou:.4f}, mean acc "
           f"{mean_acc:.4f}")

    if golden_dir and os.path.isdir(golden_dir):
        from PIL import Image

        images, _ = data
        preds = saliency_step(model, torch.from_numpy(images).to(device)).cpu().numpy()
        goldens = sorted(glob.glob(os.path.join(golden_dir, "*.png")))[:len(preds)]
        maes = []
        for p, g in zip(preds, goldens):
            gold = np.asarray(Image.open(g).convert("L").resize((IMG_SIZE, IMG_SIZE)),
                              np.float32) / 255.0
            maes.append(float(np.abs(p - gold).mean()))
        report(f"- saliency MAE vs golden dir ({len(maes)} images): {np.mean(maes):.4f} "
               f"({'PASS' if np.mean(maes) < 0.02 else 'CHECK ORDERING'})")
    else:
        report("- SKIP golden-dir comparison: --basnet-golden-dir not given")


def main(argv=None) -> int:
    import torch

    from weaklysuperviseddl_tpu_torch.device import resolve_device

    ap = argparse.ArgumentParser(prog="weaklysuperviseddl_tpu_torch parity")
    ap.add_argument("--weights-dir", default="./Weights")
    ap.add_argument("--pet-root", default=None)
    ap.add_argument("--basnet-golden-dir", default=None)
    ap.add_argument("--num-images", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="the port's device (default: the card; 'cpu' to run on the CPU)")
    ap.add_argument("--out", default="PARITY.md")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    report = Report()
    report("# PARITY — real pretrained weights vs PyTorch goldens (the PyTorch port)")
    report()
    report(f"weights dir: `{args.weights_dir}`  pet root: `{args.pet_root}`  "
           f"device: `{device}`")
    report()

    data = load_pet_images(args.pet_root, args.num_images) if args.pet_root else None
    if data is None:
        rng = np.random.default_rng(0)
        images = rng.integers(0, 255, (args.num_images, IMAGE_SIZE, IMAGE_SIZE, 3)).astype(
            np.uint8)
        trimaps = [None] * args.num_images
        report("NOTE: no Pet images found — image-driven checks use synthetic "
               "inputs (same-bytes implementation parity only).")
        report()
    else:
        images, trimaps = data

    clf = find_weights(args.weights_dir, ["classifier_weights*.pth", "resnet50*.pth"])
    dl = find_weights(args.weights_dir, ["deeplabv3*.pth"])
    bn = find_weights(args.weights_dir, ["basnet.pth"])

    if clf:
        check_classifier(report, clf, images, args.num_images, device)
    else:
        report("## Classifier + LayerCAM\n- SKIP: no classifier_weights*.pth "
               "or resnet50*.pth in weights dir")
    report()
    if dl:
        check_deeplab(report, dl, images, trimaps, args.num_images, device)
    else:
        report("## DeepLabV3\n- SKIP: no deeplabv3*.pth in weights dir")
    report()
    if bn:
        check_basnet(report, bn, args.pet_root, args.basnet_golden_dir, args.num_images, device)
    else:
        report("## BASNet saliency\n- SKIP: no basnet.pth in weights dir")

    with open(args.out, "w") as f:
        f.write("\n".join(report.lines) + "\n")
    print(f"\nwrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
