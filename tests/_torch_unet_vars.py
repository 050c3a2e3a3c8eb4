"""A flax RestorationUNet with seeded, non-trivial variables for the
port's U-Net tests: the stock init has running statistics 0 / 1 and zero
biases, which would hide a swapped statistic or a dropped bias, so the
running means, variances and the biases are redrawn from a seed."""

import jax
import jax.numpy as jnp
import numpy as np

from robust_object_detection_tpu.models import unet as JU

NARROW = (8, 16, 32, 64)


def jax_unet(channels=NARROW, seed: int = 0, patch: int = 32):
    """(flax model, variables as nested dicts of numpy arrays)."""
    model = JU.create(channels)
    v = jax.device_get(JU.init_variables(model, jax.random.key(seed), patch))
    v = jax.tree.map(np.array, v)
    rng = np.random.RandomState(seed + 1)
    for block in v["batch_stats"].values():
        for bn in block.values():
            bn["mean"] = (rng.randn(*bn["mean"].shape) * 0.1).astype(
                np.float32)
            bn["var"] = (rng.rand(*bn["var"].shape) * 0.5 + 0.75).astype(
                np.float32)
    for name, p in v["params"].items():
        if "bias" in p:
            p["bias"] = (rng.randn(*p["bias"].shape) * 0.1).astype(
                np.float32)
    return model, v


def jnp_tree(v):
    return jax.tree.map(jnp.asarray, v)
