"""PyTorch/CUDA port of weaklysuperviseddl_tpu, for NVIDIA Hopper (H100).

The JAX package ``weaklysuperviseddl_tpu`` is the reference; this package keeps
its module names so each module's counterpart is easy to find, and imports
nothing of it. Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; without a card and without that, it raises.

Ported so far: the mask-serving path (``pipelines/serve.py``, int8 by
default) with its connected-components kernel (``ops/cc.py`` +
``csrc/cc.cu``); the weakly-supervised alternating cycle
(``pipelines/weakly.py``) with the mask-refinement, CRF-filter, LayerCAM and
window-loss kernels; the supervised baseline and the ablation grid;
BASNet saliency (``models/basnet.py``, ``pipelines/basnet_infer.py``,
``train/basnet.py``); the ('data', 'model') mesh (``parallel/``: one
process per device under torch.distributed, data- and tensor-parallel
training, H-sharded refinement, mesh serving, the ``dryrun`` command); and
the reference-named entry points (``compat/``) over classic CAM
(``cam/cam.py``).
"""

from weaklysuperviseddl_tpu_torch.device import resolve_device
from weaklysuperviseddl_tpu_torch.models.basnet import BASNet
from weaklysuperviseddl_tpu_torch.pipelines.basnet_infer import build_basnet, run_inference

__all__ = ["BASNet", "build_basnet", "resolve_device", "run_inference"]
