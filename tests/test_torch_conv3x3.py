"""Port K3-f (robust_object_detection_tpu_torch/ops/conv3x3.py) against the
reference Pallas kernel ops/pallas_conv.conv3x3_planes.

On the CPU the port's wrapper runs its plain version; the Pallas kernel
runs in interpret mode (its own off-TPU default). Both take the same f32
inputs, made with numpy from a seed; the reference's planes layout
(B, H, C, W) is transposed to NHWC before comparing. f32 sums in another
order: atol 1e-5 on outputs of magnitude ~3.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from robust_object_detection_tpu.ops import pallas_conv as PC
from robust_object_detection_tpu_torch.ops import conv3x3 as C

torch.set_num_threads(1)


def _inputs(seed, b=2, h=16, w=128, cin=8, cout=16):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, cin).astype(np.float32)
    k = (rng.randn(3, 3, cin, cout) * 0.2).astype(np.float32)
    return x, k


def test_conv3x3_matches_planes_kernel():
    x, k = _inputs(0)
    ref = PC.conv3x3_planes(jnp.asarray(x.transpose(0, 1, 3, 2)),
                            jnp.asarray(k), jnp.float32)
    ref = np.asarray(ref).transpose(0, 1, 3, 2)
    out = C.conv3x3(torch.from_numpy(x), torch.from_numpy(k))
    assert out.shape == (2, 16, 128, 16)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape", [(1, 5, 7, 3, 4), (2, 9, 3, 6, 10)])
def test_conv3x3_odd_shapes_match_direct_sum(shape):
    """Shapes the TPU kernel never took (any H, W, C): the plain version
    equals the 3x3 SAME correlation written out as a sum of shifts."""
    b, h, w, cin, cout = shape
    x, k = _inputs(1, b, h, w, cin, cout)
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    ref = sum(xp[:, dy:dy + h, dx:dx + w] @ k[dy, dx]
              for dy in range(3) for dx in range(3))
    out = C.conv3x3(torch.from_numpy(x), torch.from_numpy(k))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)


def test_conv3x3_rejects_what_it_does_not_take():
    x, k = (torch.from_numpy(a) for a in _inputs(2))
    with pytest.raises(ValueError, match="channels"):
        C.conv3x3(x, k[:, :, :4])
    with pytest.raises(ValueError, match="dtype"):
        C.conv3x3(x.half(), k.half())
    with pytest.raises(ValueError, match="contiguous"):
        C.conv3x3(x.transpose(1, 2), k)
    with pytest.raises(ValueError, match="cpu or cuda"):
        C.conv3x3(x.to("meta"), k.to("meta"))


def test_conv3x3_cpu_path_launches_nothing():
    before = C.conv3x3.launches
    C.conv3x3(*(torch.from_numpy(a) for a in _inputs(3)))
    assert C.conv3x3.launches == before

