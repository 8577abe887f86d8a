"""int8 serving quality on a trained DeepLabV3, the JAX package's
tests/test_quant.py:247 on both packages (moved out of test_torch_quant.py
so that xdist starts this heavy test after the long JAX files)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_refine import single_torch_thread  # noqa: F401  (fixture)

from weaklysuperviseddl_tpu.ops import quant as jax_quant
from weaklysuperviseddl_tpu_torch.models.deeplabv3 import DeepLabV3
from weaklysuperviseddl_tpu_torch.ops import quant
from weaklysuperviseddl_tpu_torch.pipelines.serve import model_inputs

pytestmark = pytest.mark.usefixtures("single_torch_thread")


def test_deeplab_serving_quality_after_quantization():
    """JAX's ``test_deeplab_serving_quality_after_quantization`` on both
    packages: the smoke DeepLabV3 trained 3 epochs at 32² on 16 synthetic pets
    (JAX's training, lr 1e-3, batch 8), its weights bridged into the port,
    and each package's int8 PTQ calibrated on the same two batches. Each
    package's int8 masks agree with its own float masks on more than 0.99 of
    the pixels, and the port's agreement is not below JAX's by more than one
    pixel in a thousand (int8 rounding where two logits nearly tie)."""
    from weaklysuperviseddl_tpu.data.dataset import download_data
    from weaklysuperviseddl_tpu.data.preprocess import preprocess_batch as jax_preprocess
    from weaklysuperviseddl_tpu.models.deeplabv3 import DeepLabV3 as JaxDeepLabV3
    from weaklysuperviseddl_tpu.train.segmentation import _normalize_images as jax_normalize
    from weaklysuperviseddl_tpu.train.segmentation import create_seg_state, train_segmentation_model
    from weaklysuperviseddl_tpu_torch.models.jax_import import deeplab_state_dict_from_jax

    size, n = 32, 16
    ds = download_data(None, split="trainval", synthetic_size=n, image_size=size)
    images = np.stack(ds.images)
    masks = np.stack([(t == 1).astype(np.uint8) for t in ds.trimaps])
    model = JaxDeepLabV3(num_classes=2, backbone_depth=18, width_multiplier=0.25)
    state, tx = create_seg_state(model, jax.random.PRNGKey(0), input_size=size, lr=1e-3)
    state, _ = train_segmentation_model(model, state, tx, images, masks, num_epochs=3,
                                        batch_size=8, seg_size=size, log=lambda s: None)
    variables = {"params": state.params, "batch_stats": state.batch_stats}

    def serve(x):
        return model.apply(variables, x, train=False)

    x = jax_normalize(jax_preprocess(jnp.asarray(images), None, size=size)[0])
    qfn, _ = jax_quant.quantize_for_serving(serve, [(x[:8],), (x[8:],)])
    jax_float = np.asarray(jnp.argmax(serve(x), -1))
    jax_int8 = np.asarray(jnp.argmax(jax.jit(qfn)(x), -1))
    jax_agreement = float((jax_float == jax_int8).mean())

    port = DeepLabV3(2, 18, 0.25)
    port.load_state_dict(deeplab_state_dict_from_jax(jax.tree.map(np.asarray, variables)))
    port.eval()
    xt = model_inputs(torch.from_numpy(images), size)
    q = quant.Int8Quantizer(port, xt[:8])
    q.observe(xt[:8])
    q.observe(xt[8:])
    qmodel, report = q.build()
    assert len(report.rows) >= 10
    with torch.no_grad():
        port_float = port(xt).argmax(1).numpy()
        port_int8 = qmodel(xt).argmax(1).numpy()
    port_agreement = float((port_float == port_int8).mean())
    print(f"int8 vs float32 mask agreement after training: JAX {jax_agreement:.6f}, "
          f"port {port_agreement:.6f}; port vs JAX: float masks "
          f"{float((port_float == jax_float).mean()):.6f}, int8 masks "
          f"{float((port_int8 == jax_int8).mean()):.6f}")
    assert jax_agreement > 0.99, f"JAX int8 mask agreement {jax_agreement:.4f}"
    assert port_agreement > 0.99, f"port int8 mask agreement {port_agreement:.4f}"
    assert port_agreement >= jax_agreement - 1e-3, (port_agreement, jax_agreement)

