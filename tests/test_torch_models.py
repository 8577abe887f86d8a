"""Port parity: the weight bridge (models/jax_import.py) and DeepLabV3 logits
against the JAX package, with the same weights on both sides."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weaklysuperviseddl_tpu.models.deeplabv3 import DeepLabV3 as JaxDeepLabV3
from weaklysuperviseddl_tpu.models.torch_import import deeplab_variables
from weaklysuperviseddl_tpu_torch.models.deeplabv3 import DeepLabV3
from weaklysuperviseddl_tpu_torch.models.jax_import import deeplab_state_dict_from_jax
from weaklysuperviseddl_tpu_torch.models.resnet import ResNetBackbone


@functools.lru_cache(maxsize=None)
def jax_deeplab_numpy(depth, width, seed=0, size=64):
    """A JAX DeepLabV3 and random variables as numpy, in the tree its own
    ``init`` would give (``eval_shape``: traced, not run), with non-trivial BN
    statistics and affines so that eval-mode parity is a real test. Cached:
    each test reads the tree and never writes to it."""
    model = JaxDeepLabV3(num_classes=2, backbone_depth=depth, width_multiplier=width)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(seed), jnp.zeros((1, size, size, 3)))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":  # LeCun normal over (kh, kw, I)
            value = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "var":
            value = rng.uniform(0.75, 1.25, shape)
        elif name == "scale":
            value = rng.uniform(0.8, 1.2, shape)
        else:  # bias, mean
            value = 0.1 * rng.standard_normal(shape)
        return value.astype(np.float32)

    return model, jax.tree_util.tree_map_with_path(fill, shapes)


def port_from_jax(variables, depth, width):
    port = DeepLabV3(num_classes=2, backbone_depth=depth, width_multiplier=width)
    port.load_state_dict(deeplab_state_dict_from_jax(variables), strict=True)
    return port.eval()


@pytest.mark.parametrize("depth", [18, 50])
def test_weight_bridge_round_trips_exactly(depth):
    """JAX tree → port state_dict → the JAX package's own torch importer gives
    back the JAX tree, leaf for leaf."""
    _, variables = jax_deeplab_numpy(depth, 0.25)
    port = port_from_jax(variables, depth, 0.25)
    back = deeplab_variables(port.state_dict())
    want = jax.tree_util.tree_leaves_with_path(variables)
    got = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.shape == w.shape, path
        np.testing.assert_array_equal(g, w, err_msg=str(path))


@pytest.mark.parametrize("depth", [18, 50])
def test_deeplab_logits_match_jax(depth):
    """Same weights, same input: the port's logits match the JAX model's at
    the tolerance tests/test_models.py holds against a torch golden."""
    model, variables = jax_deeplab_numpy(depth, 0.25)
    port = port_from_jax(variables, depth, 0.25)
    x = np.random.default_rng(4).standard_normal((2, 64, 64, 3)).astype(np.float32)
    want = model.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = port.logits_nhwc(torch.from_numpy(x))
    assert got.shape == (2, 64, 64, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=2e-3)


@pytest.mark.parametrize("depth,dilate,channels", [
    (18, (False, True, True), {"layer1": 16, "layer2": 32, "layer3": 64, "layer4": 128}),
    (50, (False, False, True), {"layer1": 64, "layer2": 128, "layer3": 256, "layer4": 512}),
])
def test_backbone_geometry_matches_jax(depth, dilate, channels):
    """Stage channels and strides follow the JAX backbone (torchvision's
    dilation rule: a dilated stage keeps the spatial size)."""
    from weaklysuperviseddl_tpu.models.resnet import ResNetBackbone as JaxBackbone

    jb = JaxBackbone(depth=depth, width_multiplier=0.25, replace_stride_with_dilation=dilate)
    assert jb.feature_channels == channels
    tb = ResNetBackbone(depth, 0.25, replace_stride_with_dilation=dilate).eval()
    assert tb.feature_channels == channels
    x = np.zeros((1, 64, 64, 3), np.float32)
    jfeats, _ = jax.eval_shape(jb.init_with_output, jax.random.PRNGKey(0), jnp.asarray(x))
    with torch.no_grad():
        tfeats = tb(torch.from_numpy(x).permute(0, 3, 1, 2))
    for name in ("stem", "layer1", "layer2", "layer3", "layer4"):
        assert tuple(tfeats[name].permute(0, 2, 3, 1).shape) == jfeats[name].shape, name
