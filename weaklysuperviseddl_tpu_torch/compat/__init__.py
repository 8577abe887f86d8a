"""Reference-named entry points with the reference's signatures (port of
weaklysuperviseddl_tpu/compat/).

The north star keeps the reference's public entry points —
``ClassificationModel``, ``LayerCAM``, ``PsuedoMasks``, ``SegmentationModel``,
``RunInference`` and their sibling modules — callable as the reference's
scripts call them. Each module here is a thin adapter from that surface onto
the port's functions. Inputs may be numpy or torch, NCHW or NHWC, batched or
not (``_adapt.py``); where the JAX package returns a ``jnp`` array the port
returns a ``torch.Tensor`` of the same shape and layout on the model's
device, and where JAX returns numpy the port does too. A signature with
``device=`` uses it (None: the card, raising without one); the classes
without one follow their model's device.
"""

from weaklysuperviseddl_tpu_torch.compat import (  # noqa: F401
    ClassificationModel,
    ExtraUtilities,
    LayerCAM,
    PsuedoMasks,
    SegmentationDataset,
    SegmentationModel,
)
