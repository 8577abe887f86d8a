"""BASNet training over a run against the JAX package (its own file, so that
the test workers run it beside ``test_torch_basnet.py``).

Both packages' ``train_basnet`` from one bridged initialisation in float64
(JAX under ``jax.enable_x64``): 8 synthetic pets at 32², batch 4, 4 epochs,
clip 1.0 and the cosine lr, the same epoch orders from the same seed. Float64
because from random weights float32's own gradient noise is 10-27 % of a
tensor's largest entry (``test_torch_basnet.py``), which a run amplifies.
Two float32 steps inside JAX's float64 model are made float64 here, as the
one-step test makes the SSIM window float64: its bilinear resize computes in
float32 (``ops/resize.py``), and its ``train_basnet`` uploads the targets in
float32, which its SSIM blurs with the float64 window after a cast (exact on
{0, 1}). The port's resize keeps float64.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_basnet import CLIP, LR, LR_END, SIZE, _perturb
from test_torch_refine import single_torch_thread  # noqa: F401  (fixture)

import weaklysuperviseddl_tpu.models.basnet as jax_basnet
import weaklysuperviseddl_tpu.train.basnet as jax_train
import weaklysuperviseddl_tpu_torch.train.basnet as port_train
from weaklysuperviseddl_tpu.models.torch_import import torch_to_flax
from weaklysuperviseddl_tpu_torch.data.synthetic import synthetic_pet_arrays
from weaklysuperviseddl_tpu_torch.models.basnet import BASNet
from weaklysuperviseddl_tpu_torch.models.resnet import init_weights

pytestmark = pytest.mark.usefixtures("single_torch_thread")


def _resize_bilinear_in_place_dtype(x, size, antialias=False, axes=None):
    """JAX's ``resize_bilinear`` on NHWC maps without its float32 round trip."""
    shape = (x.shape[0], *size, x.shape[3])
    return jax.image.resize(x, shape, method="linear", antialias=antialias)


def test_train_basnet_run_matches_jax_in_float64():
    """The per-epoch losses of the first two epochs (four steps) agree
    within 1e-6 relative, those of the last two within 1e-3: the two
    trainers are the same function over a run, so the gap between the two
    packages' demos comes from elsewhere (their initial weights and
    devices).

    Why the last two epochs are held to 1e-3. The gap starts at float64
    round-off and grows about 50-fold a step, the random-init model's own
    conditioning (the one that puts float32's gradient 10-27 % off
    float64's): with one step an epoch (4 pets, batch 4) the relative gap of
    steps 1-7 measured 1.2e-15, 5.3e-12, 1.1e-10, 2.1e-9, 8.5e-8, 8.4e-6 and
    1.4e-4, a smooth growth with no step where a fault would jump."""
    port = _perturb(init_weights(BASNet(), torch.Generator().manual_seed(0)), seed=1)
    pets, _, trimaps = synthetic_pet_arrays(8, image_size=SIZE, seed=5)
    mean, std = np.array([0.485, 0.456, 0.406]), np.array([0.229, 0.224, 0.225])
    images = (pets.astype(np.float64) - mean) / std
    targets = (trimaps == 1).astype(np.float64)
    kw = dict(epochs=4, batch_size=4, lr=LR, clip_norm=CLIP, lr_end=LR_END, seed=0,
              log=lambda *_: None)
    before = {k: v.double() if v.is_floating_point() else v for k, v in port.state_dict().items()}
    _, got = port_train.train_basnet(copy.deepcopy(port).double(), images, targets, **kw)
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        window = jnp.asarray(np.asarray(jax_train._gaussian_window()), jnp.float64)
        blur = jax_train._separable_blur
        mp.setattr(jax_train, "_gaussian_window", lambda *args: window)
        mp.setattr(jax_train, "_separable_blur", lambda x, win: blur(x.astype(win.dtype), win))
        mp.setattr(jax_basnet, "resize_bilinear", _resize_bilinear_in_place_dtype)
        params, stats = jax.tree.map(jnp.asarray, torch_to_flax(before))
        _, want = jax_train.train_basnet(jax_basnet.BASNet(dtype=jnp.float64),
                                         {"params": params, "batch_stats": stats},
                                         images, targets, **kw)
    print(f"train_basnet per-epoch losses: port {got}, JAX {want}")
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(got[:2], want[:2], rtol=1e-6)
    np.testing.assert_allclose(got[2:], want[2:], rtol=1e-3)
