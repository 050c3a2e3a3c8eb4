"""The arithmetic of K2's f32 route (csrc/front_tf32.cuh), emulated on the
CPU: the YOLOv8 P1/P2 front and its backward in split ("3x") TF32.

The kernels split every f32 operand into hi = tf32(a) and lo = tf32(a -
hi) and accumulate lo*hi + hi*lo + hi*hi in f32 (tests/
test_torch_conv3x3_tf32.py holds that split; its ``mm3`` is reused here).
Here the front's GEMMs run through ``mm3`` in the kernels' decomposition:

  * P1: the stride-2 im2col of x (27 columns) times k1; eval: BN1 + SiLU
    on the f32 sums; train: the batch statistics of y1, the fold, and a1 =
    silu(g1 y1 + b1) formed in f32 before it is split (P2's in-place
    transform);
  * P2: the stride-2 im2col of a1 times k2, and BN2's statistics;
  * dA1: the transposed stride-2 conv as the four parity classes of the
    y1 pixel (1, 2, 2 and 4 taps over one e2 patch), then the BN1 + SiLU
    chain; dk2 and dk1: pixels as K (a1 (x) e2, im2col(x) (x) e1).

The same function in float64 (numpy, float64 products) is the yardstick:

  * the 3x emulation sits well inside the f32 bars of chip_smoke.py (y2
    1e-4 x max|ref|, statistics and gradients 1e-3) against float64;
    one-pass TF32's error is recorded beside it, and is far larger;
  * the float64 emulation is the front: it equals the autograd of the
    port's plain version (ops/yolo_front.front_fused_reference, f32) at
    f32 tolerance, so the decomposition above (the parity classes
    included) computes the reference's gradients;
  * the 3x emulation equals the reference's Pallas front
    (pallas_yolo_front.front_fused, front_fused_inference, f32,
    interpreted) and its VJP at tests/test_torch_train_kernels.py's
    tolerances (3e-3 for y2: the kernel folds BN as g y + b; 6e-3 for
    gradients).

The card's kernels are held against the plain version by chip_smoke.py
and tests/test_torch_gpu.py; this file holds the arithmetic they follow.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robust_object_detection_tpu.ops import pallas_stem as PS
from robust_object_detection_tpu.ops import pallas_yolo_front as YF
from robust_object_detection_tpu_torch.ops import yolo_front as TF
from test_torch_conv3x3_tf32 import mm3, split, tf32_rna

torch.set_num_threads(1)

EPS = 1e-3
# (B, H, W, C1, C2): the path's front cut to size, and an odd one (H/4,
# W/4 odd, channel counts that are not multiples of 4)
SHAPES = [(2, 32, 32, 48, 96), (1, 18, 22, 12, 20)]
Y2_BAR, SUM_BAR = 1e-4, 1e-3   # chip_smoke.py's f32 K2 tolerances
# (0, 1): rows or columns of a y1 parity class; {tap: patch offset} as
# tests/test_torch_front_plan.PARITY_TAPS
PARITY_TAPS = ({1: 0}, {0: 1, 2: 0})


def mm64(a, b):
    return a.astype(np.float64) @ b.astype(np.float64)


ROUTES = {"3x": (mm3, np.float32),
          "1x": (lambda a, b: mm3(a, b, passes=1), np.float32),
          "float64": (mm64, np.float64)}


def _inputs(shape, seed=0):
    b, h, w, c1, c2 = shape
    rng = np.random.RandomState(seed)
    f = np.float32
    return dict(
        x=rng.rand(b, h, w, 3).astype(f),
        k1=(rng.randn(3, 3, 3, c1) * 0.2).astype(f),
        sc1=(rng.rand(c1) + 0.5).astype(f),
        bi1=(rng.randn(c1) * 0.1).astype(f),
        k2=(rng.randn(3, 3, c1, c2) * 0.1).astype(f),
        m1=(rng.randn(c1) * 0.1).astype(f),
        v1=(rng.rand(c1) + 0.5).astype(f),
        dy2=rng.randn(b, -(-(h // 2) // 2), -(-(w // 2) // 2), c2).astype(f),
        dstats=[(rng.randn(c) * 0.1).astype(f) for c in (c1, c1, c2, c2)])


def im2col_s2(x):
    """(B H' W', 9 C) rows of a 3x3 stride-2 pad-1 conv's input,
    tap-major (HWIO order), and the output shape (B, H', W')."""
    b, h, w, c = x.shape
    ho, wo = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    cols = [xp[:, ky:ky + 2 * ho:2, kx:kx + 2 * wo:2]
            for ky in range(3) for kx in range(3)]
    return np.concatenate(cols, -1).reshape(-1, 9 * c), (b, ho, wo)


def _sigmoid(z):
    return 1 / (1 + np.exp(-z))


def _stats(y, ft):
    """flax's fast variance, as the kernels' partials give it."""
    m = y.mean(0, dtype=np.float64).astype(ft)
    ms = (y.astype(np.float64) ** 2).mean(0).astype(ft)
    return m, np.maximum(ms - m * m, 0).astype(ft)


def front(d, route, train=True):
    """The front (and, in train mode, its backward for d's cotangents)
    through `route`'s products, in its float type."""
    mm, ft = ROUTES[route]
    x, k1, k2 = d["x"].astype(ft), d["k1"].astype(ft), d["k2"].astype(ft)
    sc1, bi1 = d["sc1"].astype(ft), d["bi1"].astype(ft)
    c1, c2 = k1.shape[3], k2.shape[3]
    col1, (b, h2, w2) = im2col_s2(x)
    y1 = mm(col1, k1.reshape(27, c1)).astype(ft)
    if train:
        mean1, var1 = _stats(y1, ft)
    else:
        mean1, var1 = d["m1"].astype(ft), d["v1"].astype(ft)
    g1 = (sc1 / np.sqrt(var1 + ft(EPS))).astype(ft)
    b1 = (bi1 - mean1 * g1).astype(ft)
    z1 = (y1 * g1 + b1).astype(ft)
    a1 = (z1 * _sigmoid(z1)).astype(ft)     # silu, in f32 before the split
    a1 = a1.reshape(b, h2, w2, c1)
    col2, (_, h4, w4) = im2col_s2(a1)
    y2 = mm(col2, k2.reshape(9 * c1, c2)).astype(ft)
    out = dict(y2=y2.reshape(b, h4, w4, c2))
    if not train:
        return out
    mean2, var2 = _stats(y2, ft)
    out.update(mean1=mean1, var1=var1, mean2=mean2, var2=var2)

    # K2-b: e2, dA1 by parity classes + the BN1 chain, dk2, bn_chain, dk1
    dmean1, dvar1, dmean2, dvar2 = (t.astype(ft) for t in d["dstats"])
    n1, n2 = ft(b * h2 * w2), ft(b * h4 * w4)
    ds2, dss2 = dmean2 / n2 - 2 * mean2 * dvar2 / n2, dvar2 / n2
    e2 = (d["dy2"].astype(ft).reshape(-1, c2) + ds2
          + 2 * y2 * dss2).astype(ft)
    e2p = np.pad(e2.reshape(b, h4, w4, c2), ((0, 0), (0, 1), (0, 1), (0, 0)))
    da1 = np.zeros((b, h2, w2, c1), ft)
    for py in (0, 1):
        for px in (0, 1):
            ny, nx = len(range(py, h2, 2)), len(range(px, w2, 2))
            if not (ny and nx):
                continue
            acc = np.zeros((b * ny * nx, c1), ft)
            for ky, dr in PARITY_TAPS[py].items():
                for kx, dc in PARITY_TAPS[px].items():
                    a = e2p[:, dr:dr + ny, dc:dc + nx].reshape(-1, c2)
                    acc = (acc + mm(a, k2[ky, kx].T)).astype(ft)
            da1[:, py::2, px::2] = acc.reshape(b, ny, nx, c1)
    da1 = da1.reshape(-1, c1)
    sg = _sigmoid(z1)
    dpre = (da1 * (sg * (1 + z1 * (1 - sg)))).astype(ft)
    dy1 = (dpre * g1).astype(ft)
    dg = (dpre * y1).sum(0, dtype=np.float64).astype(ft)
    db = dpre.sum(0, dtype=np.float64).astype(ft)
    r = (1 / np.sqrt(var1 + ft(EPS))).astype(ft)
    dsc1 = dg * r - db * mean1 * r
    dm = -db * sc1 * r + dmean1
    dv = (dg - db * mean1) * sc1 * ft(-0.5) * r * r * r + dvar1
    ds1, dss1 = dm / n1 - 2 * mean1 * dv / n1, dv / n1
    e1 = (dy1 + ds1 + 2 * y1 * dss1).astype(ft)
    out.update(dk1=mm(col1.T, e1).reshape(3, 3, 3, c1).astype(ft),
               dk2=mm(col2.T, e2).reshape(3, 3, c1, c2).astype(ft),
               dsc1=dsc1.astype(ft), dbi1=db)
    return out


def _err(a, ref):
    return float(np.abs(np.asarray(a, np.float64) - ref).max()
                 / np.abs(ref).max())


GRADS = ("dk1", "dk2", "dsc1", "dbi1")
STATS = ("mean1", "var1", "mean2", "var2")


@pytest.fixture(scope="module")
def runs():
    """Every route of every shape, eval and train, computed once."""
    out = {}
    for shape in SHAPES:
        d = _inputs(shape)
        for route in ROUTES:
            out[shape, route, True] = front(d, route)
            out[shape, route, False] = front(d, route, train=False)
    return out


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("shape", SHAPES)
def test_split_forward_holds_float64(runs, shape, train):
    """y2 (and the train statistics) of the 3x route within a tenth of the
    f32 bars of float64; one pass of TF32 at least 10x further off."""
    ref, r3, r1 = (runs[shape, k, train] for k in ("float64", "3x", "1x"))
    e3, e1 = _err(r3["y2"], ref["y2"]), _err(r1["y2"], ref["y2"])
    print(f"{shape} {'train' if train else 'eval'} y2 vs float64: 3x {e3}, "
          f"one pass {e1}")
    assert e3 <= 0.1 * Y2_BAR and e1 >= 10 * e3
    for k in STATS if train else ():
        assert _err(r3[k], ref[k]) <= 0.1 * SUM_BAR


@pytest.mark.parametrize("name", GRADS)
@pytest.mark.parametrize("shape", SHAPES)
def test_split_backward_holds_float64(runs, shape, name):
    """dk1, dk2, dsc1, dbi1 of the 3x route (dA1 by parity classes, dk2
    and dk1 with pixels as K) within a tenth of the 1e-3 bar of float64;
    one pass of TF32 at least 10x further off (at these sizes still under
    the bar: a bar that sees the backward alone is set on the card)."""
    ref, r3, r1 = (runs[shape, k, True][name]
                   for k in ("float64", "3x", "1x"))
    e3, e1 = _err(r3, ref), _err(r1, ref)
    print(f"{shape} {name} vs float64: 3x {e3}, one pass {e1}")
    assert e3 <= 0.1 * SUM_BAR and e1 >= 10 * e3


def _torch_front(d, train):
    t = {k: torch.from_numpy(d[k]) for k in ("x", "k1", "sc1", "bi1", "k2",
                                             "m1", "v1")}
    if not train:
        c2 = d["k2"].shape[3]
        return dict(y2=TF.front_inference_reference(
            t["x"], t["k1"], t["sc1"], t["bi1"], t["k2"],
            (t["m1"], torch.zeros(c2)), (t["v1"], torch.ones(c2))).numpy())
    params = [t[k].clone().requires_grad_() for k in ("k1", "sc1", "bi1",
                                                      "k2")]
    outs = TF.front_fused_reference(t["x"], *params)
    cots = (torch.from_numpy(d["dy2"]),
            *(torch.from_numpy(s) for s in d["dstats"]))
    grads = torch.autograd.grad(outs, params, cots)
    res = {k: v.detach().numpy() for k, v in zip(("y2", *STATS), outs)}
    res.update(zip(("dk1", "dsc1", "dbi1", "dk2"),
                   (g.numpy() for g in grads)))
    return res


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("shape", SHAPES)
def test_float64_emulation_is_the_front(runs, shape, train):
    """The decomposition computes the plain front and the autograd of it
    (f32, so f32 tolerances: 1e-5 x max|ref| for y2 and the statistics,
    1e-4 for the gradients)."""
    ref = _torch_front(_inputs(shape), train)
    emu = runs[shape, "float64", train]
    for k, v in ref.items():
        bar = 1e-4 if k in GRADS else 1e-5
        assert _err(v, emu[k]) <= bar, k


@pytest.fixture
def interpret_mode(monkeypatch):
    monkeypatch.setattr(PS, "_INTERPRET", True)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_split_front_matches_the_pallas_front(runs, interpret_mode, train):
    """The 3x route against the reference's fused front in f32
    (interpreted Pallas), forward and, in train mode, the VJP for the same
    cotangents."""
    shape = SHAPES[0]
    d = _inputs(shape)
    emu = runs[shape, "3x", train]
    j = {k: jnp.asarray(d[k]) for k in ("x", "k1", "sc1", "bi1", "k2", "m1",
                                        "v1")}
    c2 = d["k2"].shape[3]
    planes = lambda y: np.asarray(y).transpose(0, 1, 3, 2)  # -> NHWC
    if not train:
        y2 = YF.front_fused_inference(
            j["x"], j["k1"], j["sc1"], j["bi1"], j["k2"],
            (j["m1"], jnp.zeros(c2)), (j["v1"], jnp.ones(c2)),
            dtype=jnp.float32)
        assert _err(emu["y2"], planes(y2)) <= 3e-3
        return

    def f(k1, sc1, bi1, k2):
        return YF.front_fused(j["x"], k1, sc1, bi1, k2, dtype=jnp.float32)
    outs, vjp = jax.vjp(f, j["k1"], j["sc1"], j["bi1"], j["k2"])
    cots = (jnp.asarray(d["dy2"]).transpose(0, 1, 3, 2),
            *map(jnp.asarray, d["dstats"]))
    grads = vjp(cots)
    assert _err(emu["y2"], planes(outs[0])) <= 3e-3
    for k, o in zip(STATS, outs[1:]):
        assert _err(emu[k], np.asarray(o)) <= 1e-3, k
    for k, g in zip(("dk1", "dsc1", "dbi1", "dk2"), grads):
        assert _err(emu[k], np.asarray(g)) <= 6e-3, k


@pytest.mark.parametrize("route", ["3x", "1x"])
def test_the_split_is_exact_where_it_should_be(route):
    """hi + lo reproduces an f32 value to within 2^-22 of it (lo's own
    rounding), and both halves are TF32 values: the products the kernels
    feed the tensor cores are exact in f32."""
    rng = np.random.RandomState(1)
    a = (rng.randn(4096) * 10.0 ** rng.randint(-6, 6, 4096)).astype(
        np.float32)
    hi, lo = split(a)
    assert np.array_equal(tf32_rna(hi), hi) and np.array_equal(tf32_rna(lo),
                                                               lo)
    rel = np.abs((hi.astype(np.float64) + lo) - a) / np.abs(a)
    assert rel.max() <= 2.0 ** -22
    # one pass keeps hi alone: 2^-11 relative at worst
    mm = ROUTES[route][0]
    b = np.ones((1, 1), np.float32)
    got = mm(a[:, None], b)[:, 0]
    want = hi if route == "1x" else a
    assert np.abs(got - want).max() <= 2.0 ** -21 * np.abs(a).max()
