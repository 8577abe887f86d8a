"""Hand JAX copies of torch memory, never views of it.

``tensor.numpy()`` is a view of the tensor's buffer, and on the CPU
``jnp.asarray`` of a numpy array may alias it too (whether it does depends on
the buffer's alignment). JAX dispatches asynchronously, so a JAX call built on
such an array can read a torch buffer after the test has changed it in place,
for example a training-mode forward that updates BatchNorm's running
statistics. Every port test that builds JAX inputs from torch memory goes
through these helpers."""

import jax
import jax.numpy as jnp
import numpy as np


def host_state(state_dict: dict) -> dict:
    """A torch state dict as numpy arrays that own their memory (what the JAX
    package's importers, ``torch_to_flax`` and the rest, take as they are)."""
    return {k: np.array(v.detach().cpu().numpy(), copy=True) for k, v in state_dict.items()}


def jax_tree(tree):
    """``jnp.asarray`` of every leaf, each from a fresh numpy copy."""
    return jax.tree.map(lambda a: jnp.asarray(np.array(a, copy=True)), tree)
