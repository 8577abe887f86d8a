"""The models both sides of a cell are built from: the reference's layout
(``reference/models.py``, on the meta device for counting and for the
weights' layout) and the program's model holding the same weights, by
configuration file. Every driver and reader builds its models here, so that
one traffic kind's window code holds no other kind's models."""

from __future__ import annotations

import torch


def set_precision(config: dict):
    """TF32 on or off for cuDNN and cuBLAS, as the configuration states."""
    torch.backends.cudnn.allow_tf32 = bool(config["tf32"])
    torch.backends.cuda.matmul.allow_tf32 = bool(config["tf32"])


def reference_model(config: dict, device="meta"):
    """The plain reference's model of ``config``: DeepLabV3 where the file
    names ASPP rates, else the CAM classifier."""
    from benchmark.reference.models import Classifier, DeepLabV3

    with torch.device(device):
        if "aspp_rates" in config:
            return DeepLabV3(config["num_classes"], tuple(config["aspp_rates"]),
                             config["aspp_channels"], config["dropout"],
                             width=config.get("width_multiplier", 1.0))
        return Classifier(config["num_classes"], width=config.get("width_multiplier", 1.0))


def program_model(config: dict, weights: dict, device):
    """The program's model of ``config`` on ``device`` holding ``weights``
    (DeepLabV3's buffers the weights lack, zeroed; the classifier in eval
    mode, on its running statistics)."""
    if "aspp_rates" in config:
        from weaklysuperviseddl_tpu_torch.models.deeplabv3 import DeepLabV3

        with torch.device("meta"):
            model = DeepLabV3(config["num_classes"], config["backbone_depth"],
                              config.get("width_multiplier", 1.0), dtype=config["dtype"])
        model.to_empty(device=device)
        model.load_state_dict(weights, strict=True)
        with torch.no_grad():
            for name, b in model.named_buffers():
                if name not in weights:
                    b.zero_()
        return model
    from weaklysuperviseddl_tpu_torch.models.classifier import CamClassifier

    with torch.device("meta"):
        model = CamClassifier(config["num_classes"], config["depth"],
                              config.get("width_multiplier", 1.0), dilate_layer4=True,
                              dtype=config["dtype"])
    model.to_empty(device=device)
    model.load_state_dict(weights, strict=True)
    return model.eval()
