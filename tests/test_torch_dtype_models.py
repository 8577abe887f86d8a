"""bfloat16 DeepLabV3 and classifier forwards and three DeepLabV3 training
steps against the JAX package's bfloat16 and float32 (moved out of
test_torch_dtype.py, whose helpers they share by import, so that xdist
starts this heavy file after the long JAX files)."""

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_dtype import (
    BF16,
    _NoDropout,
    _classifiers,
    _images,
    assert_within_jax_rounding,
    dist,
    tree_dist,
)
from test_torch_models import jax_deeplab_numpy
from test_torch_refine import single_torch_thread  # noqa: F401  (fixture)

from weaklysuperviseddl_tpu.models.deeplabv3 import DeepLabV3 as JaxDeepLabV3
from weaklysuperviseddl_tpu.models.torch_import import deeplab_variables
from weaklysuperviseddl_tpu.train.guard import apply_if_finite_fast
from weaklysuperviseddl_tpu.train.segmentation import make_seg_train_step
from weaklysuperviseddl_tpu_torch.models.deeplabv3 import DeepLabV3
from weaklysuperviseddl_tpu_torch.models.jax_import import deeplab_state_dict_from_jax
from weaklysuperviseddl_tpu_torch.train.guard import GuardedAdam
from weaklysuperviseddl_tpu_torch.train.segmentation import SegTrainState, seg_train_step

pytestmark = pytest.mark.usefixtures("single_torch_thread")


@pytest.mark.parametrize("depth", [18, 50])
def test_deeplab_logits_bf16(depth):
    """Eval-mode logits at width 0.25, 64² (every ASPP rate on the tap
    plan), and argmax agreement with JAX's bfloat16 >= 0.999."""
    model, variables = jax_deeplab_numpy(depth, 0.25)
    x = np.random.default_rng(4).standard_normal((2, 64, 64, 3)).astype(np.float32)
    b = np.asarray(model.apply(variables, jnp.asarray(x), train=False))
    jbf = JaxDeepLabV3(num_classes=2, backbone_depth=depth, width_multiplier=0.25, dtype=BF16)
    a = np.asarray(jbf.apply(variables, jnp.asarray(x), train=False))
    port = DeepLabV3(2, depth, 0.25, dtype="bfloat16").eval()
    port.load_state_dict(deeplab_state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        c = port.logits_nhwc(torch.from_numpy(x))
    assert c.dtype == torch.float32 and a.dtype == np.float32
    c = c.numpy()
    assert_within_jax_rounding(f"DeepLabV3-{depth} logits", dist(c, a), dist(a, b))
    agree = float((c.argmax(-1) == a.argmax(-1)).mean())
    assert agree >= 0.999, f"argmax agreement with JAX bf16 {agree}"


def test_seg_train_steps_bf16(monkeypatch):
    """Three CE steps (Adam 1e-4 behind the guard, dropout the identity) from
    the bridged depth-18 weights: the three losses and the parameters after
    the third step."""
    monkeypatch.setattr(flax.linen, "Dropout", _NoDropout)
    _, variables = jax_deeplab_numpy(18, 0.25)
    rng = np.random.default_rng(7)
    data = [(rng.standard_normal((4, 64, 64, 3)).astype(np.float32),
             rng.integers(0, 3, (4, 64, 64)).astype(np.int32), np.arange(4) < 3)
            for _ in range(3)]

    def run_jax(dtype):
        model = JaxDeepLabV3(num_classes=2, backbone_depth=18, width_multiplier=0.25,
                             dtype=dtype)
        tx = apply_if_finite_fast(optax.adam(1e-4))
        params = jax.tree.map(jnp.array, variables["params"])
        stats = jax.tree.map(jnp.array, variables["batch_stats"])
        opt = tx.init(params)
        step = make_seg_train_step(model, tx)
        losses = []
        for x, m, v in data:
            params, stats, opt, loss = step(params, stats, opt, jnp.asarray(x), jnp.asarray(m),
                                            jnp.asarray(v), jax.random.PRNGKey(0))
            losses.append(float(loss))
        return np.array(losses), jax.tree.map(np.asarray, params)

    a_loss, a_params = run_jax(BF16)
    b_loss, b_params = run_jax(jnp.float32)
    port = DeepLabV3(2, 18, 0.25, dtype="bfloat16")
    port.load_state_dict(deeplab_state_dict_from_jax(variables), strict=True)
    port.classifier[0].project[3] = torch.nn.Identity()
    state = SegTrainState(port, GuardedAdam(port.parameters(), lr=1e-4))
    c_loss = np.array([float(seg_train_step(state, torch.from_numpy(x), torch.from_numpy(m),
                                            torch.from_numpy(v))) for x, m, v in data])
    assert all(p.dtype == torch.float32 for p in port.parameters())
    c_params = deeplab_variables(port.state_dict())["params"]
    assert_within_jax_rounding("seg step losses", dist(c_loss, a_loss), dist(a_loss, b_loss))
    assert_within_jax_rounding("seg step parameters", tree_dist(c_params, a_params),
                               tree_dist(a_params, b_params))


def test_classifier_logits_bf16():
    jax_models, variables, port = _classifiers()
    x = _images(4)
    a, b = (np.asarray(jax_models[dt].apply(variables, jnp.asarray(x))[0]).astype(np.float32)
            for dt in (BF16, jnp.float32))
    with torch.no_grad():
        c, feats = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert c.dtype == torch.bfloat16 and all(f.dtype == torch.bfloat16 for f in feats)
    assert_within_jax_rounding("classifier logits", dist(c.float(), a), dist(a, b))

