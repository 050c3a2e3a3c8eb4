"""The arithmetic of K3's f32 route (csrc/conv3x3_tf32.cuh), emulated on
the CPU: split ("3x") TF32 on the tensor cores.

The kernels split each f32 operand a into hi = tf32(a) and lo = tf32(a -
hi) (cvt.rna.tf32.f32: round to nearest, ties away from zero, on the 13
low mantissa bits; Inf and NaN pass through), or hi = 0 and lo = a where
tf32(a) is not finite, and accumulate lo*hi + hi*lo + hi*hi in f32 (a
product of two TF32 values is exact in f32), dropping lo*lo. Here the
same split runs through an int32 view with numpy, the three products as
f32 matrix products of the im2col patches, and the result is held:

  * against float64, well inside the f32 checks' bar (K3-f 1e-4 x
    max|ref|, K3-b 1.5e-4) and within a small factor of plain f32's error;
    one-pass TF32's error is recorded beside it, and is over the bar;
  * equal, at f32 summation-order tolerance, to the reference's Pallas
    kernels (ops/pallas_conv.conv3x3_planes and its VJP, interpreted);
  * on non-finite inputs: with the guard the non-finite outputs are those
    of the float64 conv, Inf where it has Inf; without it (lo =
    tf32(Inf - Inf)) an Inf input turns its outputs into NaN.

The card's kernels are held against the plain version by chip_smoke.py
and tests/test_torch_gpu.py; this file holds the arithmetic they follow.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robust_object_detection_tpu.ops import pallas_conv as PC
from robust_object_detection_tpu_torch.ops import conv3x3 as C

torch.set_num_threads(1)

# (B, H, W, Cin, Cout): the K3 path's shape cut to size, and an odd one
SHAPES = [(2, 16, 16, 48, 48), (1, 9, 17, 5, 20)]
F_BAR, B_BAR = 1e-4, 1.5e-4  # chip_smoke.py's f32 K3-f and K3-b tolerances


def tf32_rna(a: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32: the 13 low mantissa bits rounded off, nearest,
    ties away from zero (add half their range, then mask); Inf and NaN
    unchanged."""
    a = np.asarray(a, np.float32)
    u = a.view(np.uint32).astype(np.uint64)
    r = ((u + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)
    return np.where(np.isfinite(a), r, a)


def split(a: np.ndarray, guard: bool = True):
    """(hi, lo) of the kernels' split; the guard puts a non-finite a in lo
    with hi 0."""
    a = np.asarray(a, np.float32)
    hi = tf32_rna(a)
    with np.errstate(invalid="ignore"):
        lo = tf32_rna(a - hi)
    if guard:
        finite = np.isfinite(hi)
        hi, lo = np.where(finite, hi, np.float32(0)), np.where(finite, lo, a)
    return hi, lo


def mm3(a: np.ndarray, b: np.ndarray, passes: int = 3,
        guard: bool = True) -> np.ndarray:
    """a @ b in split TF32 with f32 accumulation (passes 1: hi*hi only)."""
    ah, al = split(a, guard)
    bh, bl = split(b, guard)
    with np.errstate(invalid="ignore", over="ignore"):
        if passes == 1:
            return ah @ bh
        return (al @ bh) + (ah @ bl) + (ah @ bh)


def patches(x: np.ndarray) -> np.ndarray:
    """im2col of the 3x3 SAME conv: (B H W, 9 Cin), tap-major as HWIO."""
    b, h, w, c = x.shape
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    return np.concatenate([xp[:, dy:dy + h, dx:dx + w]
                           for dy in range(3) for dx in range(3)],
                          -1).reshape(b * h * w, 9 * c)


def conv_emulated(x, k, passes=3, guard=True):
    b, h, w, _ = x.shape
    out = mm3(patches(x), k.reshape(-1, k.shape[3]), passes, guard)
    return out.reshape(b, h, w, k.shape[3])


def wgrad_emulated(x, dy, passes=3):
    """dk (3, 3, Cin, Cout) = patches^T @ dy in split TF32."""
    cin, cout = x.shape[3], dy.shape[3]
    return mm3(patches(x).T.copy(), dy.reshape(-1, cout),
               passes).reshape(3, 3, cin, cout)


def _inputs(seed, b, h, w, cin, cout):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, cin).astype(np.float32)
    dy = rng.randn(b, h, w, cout).astype(np.float32)
    k = (rng.randn(3, 3, cin, cout) * 0.1).astype(np.float32)
    return x, dy, k


def _rel(out, ref):
    return float(np.abs(out.astype(np.float64) - ref).max()
                 / np.abs(ref).max())


def test_tf32_rounding_is_nearest_ties_away():
    """Against a float64 rounding of the significand to 11 bits; exact
    ties (the 13 low bits 0x1000) go away from zero."""
    rng = np.random.RandomState(0)
    a = (rng.randn(4096) * np.exp2(rng.randint(-30, 30, 4096))).astype(
        np.float32)
    m, e = np.frexp(a.astype(np.float64))          # a = m 2^e, |m| in [.5, 1)
    want = np.sign(m) * np.floor(np.abs(m) * 2 ** 11 + 0.5) / 2 ** 11 \
        * np.exp2(e)
    np.testing.assert_array_equal(tf32_rna(a), want.astype(np.float32))
    ties = np.array([0x3F801000, 0xBF801000, 0x3F803000], np.uint32)
    np.testing.assert_array_equal(
        tf32_rna(ties.view(np.float32)).view(np.uint32),
        np.array([0x3F802000, 0xBF802000, 0x3F804000], np.uint32))
    specials = np.array([np.inf, -np.inf, np.nan], np.float32)
    out = tf32_rna(specials)
    assert np.isposinf(out[0]) and np.isneginf(out[1]) and np.isnan(out[2])


@pytest.mark.parametrize("seed", [0, 1])
def test_split_keeps_f32_precision(seed):
    """hi and lo are TF32 (13 low bits zero), |lo| <= half a TF32 step of
    hi, and hi + lo is a within 2^-23 relative."""
    rng = np.random.RandomState(seed)
    a = (rng.randn(8192) * np.exp2(rng.randint(-20, 20, 8192))).astype(
        np.float32)
    hi, lo = split(a)
    assert not (hi.view(np.uint32) & 0x1FFF).any()
    assert not (lo.view(np.uint32) & 0x1FFF).any()
    assert (np.abs(lo) <= np.abs(hi) * 2.0 ** -11).all()
    err = np.abs(hi.astype(np.float64) + lo - a) / np.abs(a)
    assert err.max() <= 2.0 ** -23


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_holds_f32_accuracy(shape):
    """K3-f's arithmetic against float64: within 4x plain f32's error and
    under a hundredth of the 1e-4 bar; one pass of TF32 is over the bar."""
    x, _, k = _inputs(0, *shape)
    ref = patches(x).astype(np.float64) @ k.reshape(-1, shape[4]).astype(
        np.float64)
    ref = ref.reshape(*shape[:3], shape[4])
    three = _rel(conv_emulated(x, k), ref)
    one = _rel(conv_emulated(x, k, passes=1), ref)
    plain = _rel(C.conv3x3(torch.from_numpy(x), torch.from_numpy(k)).numpy(),
                 ref)
    print(f"{shape}: max err / max|ref|: 3xTF32 {three}, f32 {plain}, "
          f"1xTF32 {one}")
    assert three <= 4 * plain + 1e-7
    assert three <= F_BAR / 100
    assert one > F_BAR


@pytest.mark.parametrize("shape", SHAPES)
def test_filter_gradient_holds_f32_accuracy(shape):
    """K3-b's arithmetic (pixels as k) against float64: within 4x plain
    f32's error and well inside the 1.5e-4 bar; one pass of TF32 is over
    it."""
    x, dy, _ = _inputs(1, *shape)
    cin, cout = shape[3], shape[4]
    ref = (patches(x).astype(np.float64).T
           @ dy.reshape(-1, cout).astype(np.float64)).reshape(3, 3, cin, cout)
    three = _rel(wgrad_emulated(x, dy), ref)
    plain = _rel(C.conv3x3_wgrad(torch.from_numpy(x),
                                 torch.from_numpy(dy)).numpy(), ref)
    one = _rel(wgrad_emulated(x, dy, passes=1), ref)
    print(f"{shape}: dk max err / max|ref|: 3xTF32 {three}, f32 {plain}, "
          f"1xTF32 {one}")
    assert three <= 4 * plain + 1e-7
    assert three <= B_BAR / 100
    assert one > B_BAR


@pytest.mark.parametrize("cin,cout", [(48, 48), (8, 16)])
def test_emulation_matches_pallas_reference(cin, cout):
    """The emulated forward and filter gradient against the reference's
    interpreted Pallas kernels (conv3x3_planes and its VJP, f32) on the
    same inputs, at a shape they take (W a multiple of 128): f32 sums in
    another order, 1e-5 x max|ref|."""
    x, dy, k = _inputs(2, 2, 16, 128, cin, cout)
    xp = jnp.asarray(x.transpose(0, 1, 3, 2))
    y, vjp = jax.vjp(lambda a, b: PC.conv3x3_planes(a, b, jnp.float32), xp,
                     jnp.asarray(k))
    _, dk = vjp(jnp.asarray(dy.transpose(0, 1, 3, 2)))
    y = np.asarray(y).transpose(0, 1, 3, 2)
    dk = np.asarray(dk)
    fwd = conv_emulated(x, k)
    wg = wgrad_emulated(x, dy)
    assert np.abs(fwd - y).max() <= 1e-5 * np.abs(y).max()
    assert np.abs(wg - dk).max() <= 1e-5 * np.abs(dk).max()


@pytest.mark.parametrize("bad", [np.inf, -np.inf, np.nan])
def test_non_finite_input_gives_the_f32_result(bad):
    """A non-finite x, with a random filter and with one of TF32 values
    (lo = 0): with the guard the outputs are Inf, -Inf and NaN exactly
    where the float64 conv's are; without it an Inf input turns its
    outputs into NaN (lo = tf32(Inf - Inf))."""
    x, _, k = _inputs(3, 1, 9, 17, 8, 16)
    k = np.concatenate([k, tf32_rna(k)], -1)
    x[0, 4, 5, 3] = bad
    with np.errstate(invalid="ignore"):
        ref = (patches(x).astype(np.float64)
               @ k.reshape(-1, 32).astype(np.float64)).reshape(1, 9, 17, 32)
    out = conv_emulated(x, k)
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    np.testing.assert_array_equal(np.isposinf(out), np.isposinf(ref))
    np.testing.assert_array_equal(np.isneginf(out), np.isneginf(ref))
    assert np.isfinite(ref).sum() == np.isfinite(out).sum() > 0
    unguarded = conv_emulated(x, k, guard=False)
    if np.isinf(bad):
        assert np.isinf(ref).any() and not np.isinf(unguarded).any()
        assert np.isnan(unguarded).sum() > np.isnan(ref).sum()
