"""Real-file ``.pth`` ingestion: load a committed torch-serialized checkpoint
(tests/fixtures/micro_bottleneck.pth, produced by scripts/make_micro_fixture.py
via ``torch.save`` — the exact serialization the reference uses,
ref AlternatingDirectionCutLoss.py:483-487) and reproduce the torch eval-mode
forward through the flax Bottleneck. Unlike the mirror-model parity tests,
this exercises load_pth on actual bytes on disk."""

import os

import numpy as np
import jax.numpy as jnp
from torch_bridge import host_state, jax_tree

from weaklysuperviseddl_tpu.models.resnet import Bottleneck
from weaklysuperviseddl_tpu.models.torch_import import load_pth, torch_to_flax

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


def test_pth_file_ingestion_forward_parity():
    state = load_pth(os.path.join(FIXTURES, "micro_bottleneck.pth"))
    assert any(k.startswith("layer1.0.") for k in state)
    params, batch_stats = torch_to_flax(host_state(state))
    golden = np.load(os.path.join(FIXTURES, "micro_bottleneck_golden.npz"))

    block = Bottleneck(planes=8, stride=1, dilation=1, has_downsample=True)
    variables = {
        "params": params["layer1_0"],
        "batch_stats": batch_stats["layer1_0"],
    }
    variables = jax_tree(variables)
    y = block.apply(variables, jnp.asarray(golden["x"]), False)
    np.testing.assert_allclose(np.asarray(y), golden["y"], rtol=1e-4, atol=1e-5)
