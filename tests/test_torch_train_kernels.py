"""The training slice's kernel modules against the JAX reference, on the
CPU (the port's wrappers run their plain versions; the Pallas kernels run
in interpret mode, as the reference's own tests run them):

  * conv3x3 backward (dX through the flipped filter, dW = K3-b's plain
    version) against ``pallas_conv.conv3x3_planes`` grads, f32, within
    1e-5 x max|ref|;
  * the train-mode front against ``pallas_yolo_front.front_fused``: y2
    within 3e-3 x max|ref|, batch statistics within atol 1e-4 / rtol
    1e-3, gradients through tests/test_pallas_yolo_front.py's loss within
    6e-3 x max|ref| — that test's own bounds, set by the folded-BN
    association order;
  * K1's plain version against ``pallas_corrupt.fused_random_corruption``
    (interpret), fed the JAX choice vector: clean and blur bit-exact,
    lowres within 1 LSB; the interpreter's PRNG gives zeros, so noise is
    held to its distribution on the port only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robust_object_detection_tpu.ops import corrupt as JC
from robust_object_detection_tpu.ops import pallas_conv as PC
from robust_object_detection_tpu.ops import pallas_corrupt as PCo
from robust_object_detection_tpu.ops import pallas_stem as PS
from robust_object_detection_tpu.ops import pallas_yolo_front as YF
from robust_object_detection_tpu_torch.core.config import CorruptionConfig
from robust_object_detection_tpu_torch.ops import conv3x3 as C
from robust_object_detection_tpu_torch.ops import fused_corrupt as FC
from robust_object_detection_tpu_torch.ops import yolo_front as TF

torch.set_num_threads(1)


# ── K3: conv3x3 backward ─────────────────────────────────────────────────

def test_conv3x3_backward_matches_planes_kernel_grads():
    rng = np.random.RandomState(0)
    b, h, w, cin, cout = 2, 16, 128, 8, 16
    assert PC.supported((b, h, cin, w))
    x = rng.rand(b, h, w, cin).astype(np.float32)
    k = (rng.randn(3, 3, cin, cout) * 0.3).astype(np.float32)
    wts = rng.randn(b, h, w, cout).astype(np.float32)

    def jloss(xp, kk):
        y = PC.conv3x3_planes(xp, kk, jnp.float32)
        return jnp.sum(y * jnp.asarray(wts.transpose(0, 1, 3, 2)))
    jdx, jdk = jax.grad(jloss, (0, 1))(jnp.asarray(x.transpose(0, 1, 3, 2)),
                                       jnp.asarray(k))
    jdx = np.asarray(jdx).transpose(0, 1, 3, 2)

    xt = torch.from_numpy(x).requires_grad_()
    kt = torch.from_numpy(k).requires_grad_()
    (C.conv3x3(xt, kt) * torch.from_numpy(wts)).sum().backward()
    for out, ref in ((xt.grad.numpy(), jdx), (kt.grad.numpy(),
                                              np.asarray(jdk))):
        assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("shape", [(1, 5, 7, 3, 4), (2, 9, 3, 6, 10)])
def test_conv3x3_wgrad_reference_matches_direct_sum(shape):
    """K3-b's plain version equals dk[ky,kx] = sum x_shift^T dy, written
    out with numpy, at shapes the TPU kernel never took."""
    b, h, w, cin, cout = shape
    rng = np.random.RandomState(1)
    x = rng.randn(b, h, w, cin).astype(np.float32)
    dy = rng.randn(b, h, w, cout).astype(np.float32)
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    ref = np.stack([np.stack([
        np.einsum("bhwc,bhwd->cd", xp[:, ky:ky + h, kx:kx + w], dy)
        for kx in range(3)]) for ky in range(3)])
    out = C.conv3x3_wgrad(torch.from_numpy(x), torch.from_numpy(dy))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)


def test_conv3x3_backward_keeps_filter_dtype_and_launches_nothing():
    """A float32 master filter with bf16 activations: the product runs in
    bf16, dk comes back in f32; on the CPU nothing is launched."""
    x = torch.randn(1, 8, 8, 4).to(torch.bfloat16).requires_grad_()
    k = torch.randn(3, 3, 4, 6, requires_grad=True)
    before = (C.conv3x3.launches, C.conv3x3_wgrad.launches)
    y = C.conv3x3(x, k)
    y.float().sum().backward()
    assert y.dtype == torch.bfloat16
    assert x.grad.dtype == torch.bfloat16 and k.grad.dtype == torch.float32
    assert (C.conv3x3.launches, C.conv3x3_wgrad.launches) == before


def test_conv3x3_wgrad_rejects_what_it_does_not_take():
    x = torch.zeros(1, 4, 4, 2)
    with pytest.raises(ValueError, match="dy"):
        C.conv3x3_wgrad(x, torch.zeros(1, 4, 5, 3))
    with pytest.raises(ValueError, match="dtype"):
        C.conv3x3_wgrad(x, torch.zeros(1, 4, 4, 3, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        C.conv3x3_wgrad(x.transpose(1, 2), torch.zeros(1, 4, 4, 3))
    with pytest.raises(ValueError, match="cpu or cuda"):
        C.conv3x3_wgrad(x.to("meta"), torch.zeros(1, 4, 4, 3).to("meta"))


# ── K2: the train-mode front ─────────────────────────────────────────────

B, H, W, C1, C2 = 2, 32, 64, 16, 32


@pytest.fixture
def interpret_mode(monkeypatch):
    monkeypatch.setattr(PS, "_INTERPRET", True)


def _front_data():
    rng = np.random.RandomState(0)
    x = rng.rand(B, H, W, 3).astype(np.float32)
    params = [(rng.randn(3, 3, 3, C1) * 0.2).astype(np.float32),
              (rng.rand(C1) + 0.5).astype(np.float32),
              (rng.randn(C1) * 0.1).astype(np.float32),
              (rng.randn(3, 3, C1, C2) * 0.2).astype(np.float32)]
    bn2 = [(rng.rand(C2) + 0.5).astype(np.float32),
           (rng.randn(C2) * 0.1).astype(np.float32)]
    return x, params, bn2


def _loss(y2, m1, v1, m2, v2, sc2, bi2, lib):
    """tests/test_pallas_yolo_front.py's loss on NHWC y2: BN2 + SiLU from
    the batch statistics, a fixed weighting, and direct terms on all four
    statistics."""
    if lib is jnp:
        a2 = jax.nn.silu((y2 - m2) * jax.lax.rsqrt(v2 + PS.EPS) * sc2 + bi2)
    else:
        a2 = torch.nn.functional.silu(
            (y2 - m2) * torch.rsqrt(v2 + PS.EPS) * sc2 + bi2)
    planes = np.arange(a2.size if lib is jnp else a2.numel()).reshape(
        B, H // 4, C2, W // 4) % 7 - 3               # JAX test's order
    w = planes.transpose(0, 1, 3, 2).astype(np.float32)
    w = jnp.asarray(w) if lib is jnp else torch.from_numpy(w)
    return ((a2 * w).sum() + 0.1 * m1.sum() + 0.1 * v1.sum()
            + 0.05 * (m2 * v2).sum())


def test_front_fused_forward_matches_pallas(interpret_mode):
    x, params, _ = _front_data()
    ref = YF.front_fused(jnp.asarray(x), *map(jnp.asarray, params),
                         dtype=jnp.float32)
    out = TF.front_fused(torch.from_numpy(x),
                         *map(torch.from_numpy, params))
    y2_ref = np.asarray(ref[0]).transpose(0, 1, 3, 2)   # planes -> NHWC
    assert out[0].shape == y2_ref.shape == (B, H // 4, W // 4, C2)
    assert np.abs(out[0].numpy() - y2_ref).max() <= 3e-3 * np.abs(
        y2_ref).max()
    for o, r in zip(out[1:], ref[1:]):
        np.testing.assert_allclose(o.numpy(), r, atol=1e-4, rtol=1e-3)


def test_front_fused_grads_match_pallas(interpret_mode):
    x, params, (sc2, bi2) = _front_data()

    def jloss(p, s, b):
        y2, m1, v1, m2, v2 = YF.front_fused(jnp.asarray(x), *p,
                                            dtype=jnp.float32)
        return _loss(y2.transpose(0, 1, 3, 2), m1, v1, m2, v2, s, b, jnp)
    jg = jax.grad(jloss, (0, 1, 2))([jnp.asarray(p) for p in params],
                                    jnp.asarray(sc2), jnp.asarray(bi2))
    jgrads = [np.asarray(g) for g in (*jg[0], jg[1], jg[2])]

    tp = [torch.from_numpy(p).requires_grad_() for p in params]
    ts, tb = (torch.from_numpy(v).requires_grad_() for v in (sc2, bi2))
    _loss(*TF.front_fused(torch.from_numpy(x), *tp), ts, tb,
          torch).backward()
    for t, ref in zip((*tp, ts, tb), jgrads):
        assert np.abs(t.grad.numpy() - ref).max() <= 6e-3 * (
            np.abs(ref).max() + 1e-9)


def test_front_fused_rejects_what_it_does_not_take():
    x, params, _ = _front_data()
    t = [torch.from_numpy(p) for p in params]
    xt = torch.from_numpy(x)
    with pytest.raises(ValueError, match="even"):
        TF.front_fused(xt[:, :31], *t)
    with pytest.raises(ValueError, match="k1"):
        TF.front_fused(xt, t[0][:, :2], *t[1:])
    with pytest.raises(ValueError, match="BN1"):
        TF.front_fused(xt, t[0], t[1][:4], *t[2:])
    with pytest.raises(ValueError, match="dtype"):
        TF.front_fused(xt.half(), *t)
    with pytest.raises(ValueError, match="CUDA"):
        TF.front_fused_backward(*([xt] * 15))


def test_front_fused_cpu_path_launches_nothing():
    x, params, _ = _front_data()
    before = (TF.front_fused.launches, TF.front_fused_backward.launches)
    tp = [torch.from_numpy(p).requires_grad_() for p in params]
    sum(o.sum() for o in TF.front_fused(torch.from_numpy(x), *tp)).backward()
    assert (TF.front_fused.launches,
            TF.front_fused_backward.launches) == before


# ── K1: fused per-image corruption ───────────────────────────────────────

@pytest.fixture(scope="module")
def corrupt_case():
    """A (4, 128, 64, 3) batch and a JAX key whose choice vector holds
    clean, blur and lowres."""
    rng = np.random.RandomState(0)
    img = rng.randint(0, 255, (4, 128, 64, 3)).astype(np.float32)
    for k in range(50):
        out, choice = PCo.fused_random_corruption(
            jnp.asarray(img), jax.random.key(k), interpret=True)
        choice = np.array(choice)
        if {JC.CLEAN, JC.BLUR, JC.LOWRES} <= set(choice.tolist()):
            return img, np.asarray(out), choice
    raise AssertionError("no key in 0..49 covers clean, blur and lowres")


def test_corrupt_reference_matches_pallas(corrupt_case):
    img, ref, choice = corrupt_case
    out, got = FC.fused_random_corruption(
        torch.from_numpy(img), None, choice=choice,
        seeds=np.zeros(len(choice), np.int32))
    assert got.tolist() == choice.tolist()
    out = out.numpy()
    for i, ch in enumerate(choice):
        if ch in (JC.CLEAN, JC.BLUR):
            np.testing.assert_array_equal(out[i], ref[i])
        elif ch == JC.LOWRES:
            assert np.abs(out[i] - ref[i]).max() <= 1.0


def test_corrupt_noise_distribution_and_replayable_bits():
    """Noise on a mid-grey image: mean -0.5 +- 0.5 (truncation to
    integers takes 0.5 off a symmetric noise) and std 15 +- 0.5; the same
    seed gives the same bits, another seed other bits."""
    img = torch.full((2, 128, 128, 3), 128.0)
    choice = torch.tensor([JC.NOISE, JC.NOISE])
    out, _ = FC.fused_random_corruption(img, None, choice=choice,
                                        seeds=torch.tensor([7, 8]))
    noise = out - 128.0
    assert abs(noise.mean().item() + 0.5) <= 0.5
    assert abs(noise.std().item() - 15.0) <= 0.5
    again, _ = FC.fused_random_corruption(img, None, choice=choice,
                                          seeds=torch.tensor([7, 8]))
    assert torch.equal(out, again) and not torch.equal(out[0], out[1])
    bits = FC.noise_bits(7, 1 << 16)
    assert bits.min() >= 0 and bits.max() < 2 ** 32
    assert abs(bits.float().mean().item() / 2 ** 32 - 0.5) < 0.01


def test_corrupt_choice_draw_follows_config():
    """clean with probability 1 - p, else uniform over the three."""
    g = torch.Generator().manual_seed(0)
    choice, seeds = FC.draw_choice(4000, g, CorruptionConfig())
    counts = np.bincount(choice.numpy(), minlength=4) / 4000
    assert abs(counts[0] - 0.5) < 0.03
    assert all(abs(c - 1 / 6) < 0.03 for c in counts[1:])
    assert seeds.dtype == torch.int32 and 0 <= int(seeds.min())


def test_corrupt_rejects_what_it_does_not_take():
    with pytest.raises(ValueError, match="even"):
        FC.fused_random_corruption(torch.zeros(1, 9, 8, 3), None,
                                   choice=[0], seeds=[0])
    with pytest.raises(NotImplementedError):
        FC.fused_random_corruption(torch.zeros(1, 8, 8, 3), None,
                                   CorruptionConfig(blur_angle_deg=30.0),
                                   choice=[0], seeds=[0])
    with pytest.raises(ValueError, match="float32"):
        FC.fused_random_corruption(torch.zeros(1, 8, 8, 3,
                                               dtype=torch.uint8), None,
                                   choice=[0], seeds=[0])
