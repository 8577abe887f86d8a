"""PyTorch/CUDA port of weaklysuperviseddl_tpu, for NVIDIA Hopper (H100).

The JAX package ``weaklysuperviseddl_tpu`` is the reference; this package keeps
its module names so each module's counterpart is easy to find, and imports
nothing of it. Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; without a card and without that, it raises.

Ported so far: the mask-serving path (``pipelines/serve.py``) with its
connected-components kernel (``ops/cc.py`` + ``csrc/cc.cu``), and the
weakly-supervised alternating cycle (``pipelines/weakly.py``) with the
mask-refinement kernel (``ops/refine.py`` + ``csrc/refine.cu``).
"""

from weaklysuperviseddl_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
