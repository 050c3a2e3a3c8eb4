"""Port K2-f (robust_object_detection_tpu_torch/ops/yolo_front.py) against
the reference Pallas kernel pallas_yolo_front.front_fused_inference.

On the CPU the port's wrapper runs its plain version; the Pallas kernels
run in interpret mode (their own off-TPU default). Same f32 inputs from a
seed, sizes of tests/test_pallas_yolo_front.py. Tolerance 3e-3 x max|ref|,
as that test states: the kernel folds BN into g*y + b, which associates
differently from (y - m) * r * sc + bi.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from robust_object_detection_tpu.ops import pallas_yolo_front as YF
from robust_object_detection_tpu_torch.ops import yolo_front as TF

torch.set_num_threads(1)

B, H, W = 2, 32, 64
C1, C2 = 16, 32


def _inputs(seed, b=B, h=H, w=W, c1=C1, c2=C2):
    rng = np.random.RandomState(seed)
    return dict(
        x=rng.rand(b, h, w, 3).astype(np.float32),
        k1=(rng.randn(3, 3, 3, c1) * 0.2).astype(np.float32),
        sc1=(rng.rand(c1) + 0.5).astype(np.float32),
        bi1=(rng.randn(c1) * 0.1).astype(np.float32),
        k2=(rng.randn(3, 3, c1, c2) * 0.2).astype(np.float32),
        m1=(rng.randn(c1) * 0.1).astype(np.float32),
        v1=(rng.rand(c1) + 0.5).astype(np.float32),
        m2=(rng.randn(c2) * 0.1).astype(np.float32),
        v2=(rng.rand(c2) + 0.5).astype(np.float32))


def _port(d, to=torch.from_numpy):
    t = {k: to(v) for k, v in d.items()}
    return TF.front_inference(t["x"], t["k1"], t["sc1"], t["bi1"], t["k2"],
                              (t["m1"], t["m2"]), (t["v1"], t["v2"]))


def test_front_matches_pallas_inference():
    d = _inputs(0)
    j = {k: jnp.asarray(v) for k, v in d.items()}
    ref = YF.front_fused_inference(j["x"], j["k1"], j["sc1"], j["bi1"],
                                   j["k2"], (j["m1"], j["m2"]),
                                   (j["v1"], j["v2"]), dtype=jnp.float32)
    ref = np.asarray(ref).transpose(0, 1, 3, 2)          # planes -> NHWC
    out = _port(d).numpy()
    assert out.shape == ref.shape == (B, H // 4, W // 4, C2)
    assert np.abs(out - ref).max() <= 3e-3 * np.abs(ref).max()


def test_front_odd_quarter_sizes():
    """H, W even but not multiples of 4 (the TPU gate refused them): the
    output size is that of two stride-2 pad-1 convs."""
    out = _port(_inputs(1, h=18, w=22))
    assert out.shape == (B, 5, 6, C2)


def test_front_rejects_what_it_does_not_take():
    d = _inputs(2)
    with pytest.raises(ValueError, match="even"):
        _port(dict(d, x=d["x"][:, :31]))
    with pytest.raises(ValueError, match="k1"):
        _port(dict(d, k1=d["k1"][:, :2]))
    with pytest.raises(ValueError, match="BN1"):
        _port(dict(d, v1=d["v1"][:4]))
    with pytest.raises(ValueError, match="cpu or cuda"):
        _port(d, to=lambda a: torch.from_numpy(a).to("meta"))

