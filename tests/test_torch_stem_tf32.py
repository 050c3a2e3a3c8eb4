"""The arithmetic of K4's f32 route (csrc/front_tf32.cuh at the stem's
widths, csrc/stem_tf32.cuh), emulated on the CPU: the HGNetv2 stem and its
backward in split ("3x") TF32.

The kernels split every f32 operand into hi = tf32(a) and lo = tf32(a -
hi) and accumulate lo*hi + hi*lo + hi*hi in f32 (tests/
test_torch_conv3x3_tf32.py holds that split; its ``mm3`` is reused here).
Here the stem's GEMMs run through ``mm3`` in the kernels' decomposition:

  * stem1: the stride-2 im2col of x (27 columns) times k1; eval: BN1 +
    ReLU on the f32 sums; train: the batch statistics of y1 and a1 =
    relu(g1 y1 + b1) formed in f32 before it is split (the 2x2 forward's
    split pass);
  * stem2a, stem2b: the 2x2 convs over their 4 taps (zero pad right and
    bottom) as one GEMM of K = 4 x Cin; the pool, the concat;
  * stem3: the stride-2 im2col of the concat (576 columns) times k3;
  * d(cat): the transposed stem3 as the four parity classes of the concat
    pixel (1, 2, 2 and 4 taps over one e3 patch); the concat's backward
    (the BN2b chain, the pool's routing of a1's gradient);
  * the 2x2 convs' dX from the taps up and left (K = 4 x Cout), chained
    through the BN + ReLU below (stem2a's with the pool's gradient added);
  * the filter gradients (dk3, dk2b, dk2a, dk1) with pixels as K.

The same function in float64 (numpy, float64 products) is the yardstick:

  * the 3x emulation sits well inside the f32 bars of chip_smoke.py (y3
    1e-4 x max|ref|, statistics 1e-3, K4-b's gradients K4B_TOL 1.5e-4)
    against float64; one-pass TF32's error is recorded beside it and lies
    over K4-b's bar;
  * the float64 emulation is the stem: it equals the port's plain version
    (ops/stem.stem_reference, stem_train_reference) and the autograd of it
    at f32 tolerance, so the decomposition above (the parity classes and
    the taps up and left included) computes the reference's gradients;
  * the 3x emulation equals the reference's Pallas stem
    (pallas_stem.stem_fused_inference, stem_fused, f32, interpreted) and
    its VJP at tests/test_torch_stem_train.py's tolerances (y3 1e-4, the
    statistics 1e-5 absolute / 1e-4 relative, the gradients 2e-3; eval 3e-3
    as tests/test_torch_stem.py).

The card's kernels are held against float64 and the plain version by
chip_smoke.py and tests/test_torch_gpu.py; this file holds the arithmetic
they follow.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robust_object_detection_tpu.ops import pallas_stem as PS
from robust_object_detection_tpu_torch.ops import stem as ST
from test_torch_conv3x3_tf32 import mm3
from test_torch_front_tf32 import PARITY_TAPS, _err, _stats, im2col_s2, mm64

torch.set_num_threads(1)

EPS = 1e-3
CM = 32
# (B, H, W): the path cut to size, and an odd one (H/4 odd, H != W)
SHAPES = [(2, 32, 32), (1, 36, 52)]
Y3_BAR, SUM_BAR = 1e-4, 1e-3   # chip_smoke.py's f32 K4-f tolerances
GRAD_BAR = 1.5e-4              # chip_smoke.K4B_TOL["float32"]

ROUTES = {"3x": (mm3, np.float32),
          "1x": (lambda a, b: mm3(a, b, passes=1), np.float32),
          "float64": (mm64, np.float64)}
GRADS = ("dk1", "dsc1", "dbi1", "dk2a", "dsc2a", "dbi2a", "dk2b", "dsc2b",
         "dbi2b", "dk3")
STATS = ("mean1", "mean2a", "mean2b", "mean3", "var1", "var2a", "var2b",
         "var3")


def _inputs(shape, seed=0):
    b, h, w = shape
    rng = np.random.RandomState(seed)
    f = np.float32
    sizes = (CM, CM // 2, CM)
    return dict(
        x=rng.rand(b, h, w, 3).astype(f),
        k1=(rng.randn(3, 3, 3, CM) * 0.2).astype(f),
        k2a=(rng.randn(2, 2, CM, CM // 2) * 0.2).astype(f),
        k2b=(rng.randn(2, 2, CM // 2, CM) * 0.2).astype(f),
        k3=(rng.randn(3, 3, 2 * CM, CM) * 0.1).astype(f),
        sc=[(rng.rand(c) + 0.5).astype(f) for c in sizes],
        bi=[(rng.randn(c) * 0.1).astype(f) for c in sizes],
        means=[(rng.randn(c) * 0.1).astype(f) for c in sizes],
        variances=[(rng.rand(c) + 0.5).astype(f) for c in sizes],
        dy3=rng.randn(b, h // 4, w // 4, CM).astype(f),
        dmeans=[(rng.randn(c) * 0.1).astype(f) for c in (*sizes, CM)],
        dvars=[(rng.randn(c) * 0.1).astype(f) for c in (*sizes, CM)])


def taps2x2(a, up_left=False):
    """(B H W, 4 C) rows of a 2x2 conv's taps, tap-major as HWIO: tap (dy,
    dx) reads pixel (i + dy, j + dx), zero past the right and bottom edge
    (the forward, and the filter gradient's A); with up_left, (i - dy, j -
    dx), zero before the top and left edge (the transposed conv, dX)."""
    b, h, w, c = a.shape
    if up_left:
        ap = np.pad(a, ((0, 0), (1, 0), (1, 0), (0, 0)))
        cols = [ap[:, 1 - dy:1 - dy + h, 1 - dx:1 - dx + w]
                for dy in (0, 1) for dx in (0, 1)]
    else:
        ap = np.pad(a, ((0, 0), (0, 1), (0, 1), (0, 0)))
        cols = [ap[:, dy:dy + h, dx:dx + w] for dy in (0, 1) for dx in (0, 1)]
    return np.concatenate(cols, -1).reshape(-1, 4 * c)


def _sel(u, v):
    """The maximum's VJP weight of u against v: 1, 0.5 at a tie, 0."""
    return np.where(u > v, 1.0, np.where(u == v, 0.5, 0.0))


def pool2x2(a):
    ap = np.pad(a, ((0, 0), (0, 1), (0, 1), (0, 0)))
    h, w = a.shape[1:3]
    return np.maximum(np.maximum(ap[:, :h, :w], ap[:, :h, 1:]),
                      np.maximum(ap[:, 1:, :w], ap[:, 1:, 1:]))


def pool2x2_vjp(a, d):
    """a's gradient of the pool (max of the upper row's max and the lower
    row's) for the pool's gradient d: assemble_bwd_f32_kernel's routing."""
    b, h, w, c = a.shape
    ap = np.pad(a, ((0, 0), (1, 1), (1, 1), (0, 0)))      # a[r][s] windows
    dp = np.pad(d, ((0, 0), (1, 0), (1, 0), (0, 0)))
    out = np.zeros_like(a)
    nb = [[ap[:, r:r + h, s:s + w] for s in range(3)] for r in range(3)]
    for r in (0, 1):
        for s in (0, 1):
            top = np.maximum(nb[r][s], nb[r][s + 1])
            bot = np.maximum(nb[r + 1][s], nb[r + 1][s + 1])
            mine_row = _sel(bot, top) if r == 0 else _sel(top, bot)
            other = nb[1][0 if s == 0 else 2]
            wt = (mine_row * _sel(nb[1][1], other)).astype(a.dtype)
            out = (out + dp[:, r:r + h, s:s + w] * wt).astype(a.dtype)
    return out


def _bn_chain(dg, db, sc, mean, var, dmean, dvar, n, ft):
    """The folded-BN chain rule of bn_chain_kernel: dsc, dbi, ds, dss."""
    r = (1 / np.sqrt(var + ft(EPS))).astype(ft)
    dsc = dg * r - db * mean * r
    dm = -db * sc * r + dmean
    dv = (dg - db * mean) * sc * ft(-0.5) * r * r * r + dvar
    return (dsc.astype(ft), db.astype(ft), (dm / n - 2 * mean * dv / n)
            .astype(ft), (dv / n).astype(ft))


def _colsum(v):
    return v.sum(0, dtype=np.float64)


def stem(d, route, train=True):
    """The stem (and, in train mode, its backward for d's cotangents)
    through `route`'s products, in its float type."""
    mm, ft = ROUTES[route]
    x = d["x"].astype(ft)
    k1, k2a, k2b, k3 = (d[k].astype(ft) for k in ("k1", "k2a", "k2b", "k3"))
    sc = [v.astype(ft) for v in d["sc"]]
    bi = [v.astype(ft) for v in d["bi"]]
    out = {}

    def bn(y, i):
        if train:
            mean, var = _stats(y, ft)
        else:
            mean, var = d["means"][i].astype(ft), d["variances"][i].astype(ft)
        g = (sc[i] / np.sqrt(var + ft(EPS))).astype(ft)
        b = (bi[i] - mean * g).astype(ft)
        return mean, var, g, b

    col1, (b, h2, w2) = im2col_s2(x)
    y1 = mm(col1, k1.reshape(27, CM)).astype(ft)
    m1, v1, g1, b1 = bn(y1, 0)
    a1 = np.maximum(y1 * g1 + b1, 0).astype(ft).reshape(b, h2, w2, CM)
    col2a = taps2x2(a1)
    y2a = mm(col2a, k2a.reshape(4 * CM, CM // 2)).astype(ft)
    m2a, v2a, g2a, b2a = bn(y2a, 1)
    a2a = np.maximum(y2a * g2a + b2a, 0).astype(ft).reshape(b, h2, w2,
                                                            CM // 2)
    col2b = taps2x2(a2a)
    y2b = mm(col2b, k2b.reshape(2 * CM, CM)).astype(ft)
    m2b, v2b, g2b, b2b = bn(y2b, 2)
    a2b = np.maximum(y2b * g2b + b2b, 0).astype(ft).reshape(b, h2, w2, CM)
    cat = np.concatenate([pool2x2(a1), a2b], -1)
    col3, (_, h4, w4) = im2col_s2(cat)
    y3 = mm(col3, k3.reshape(9 * 2 * CM, CM)).astype(ft)
    out["y3"] = y3.reshape(b, h4, w4, CM)
    if not train:
        return out
    m3, v3 = _stats(y3, ft)
    out.update(zip(STATS, (m1, m2a, m2b, m3, v1, v2a, v2b, v3)))

    # K4-b
    dmean = [v.astype(ft) for v in d["dmeans"]]
    dvar = [v.astype(ft) for v in d["dvars"]]
    n1, n3 = ft(b * h2 * w2), ft(b * h4 * w4)
    ds3, dss3 = dmean[3] / n3 - 2 * m3 * dvar[3] / n3, dvar[3] / n3
    e3 = (d["dy3"].astype(ft).reshape(-1, CM) + ds3 + 2 * y3 * dss3).astype(
        ft)
    out["dk3"] = mm(col3.T, e3).reshape(3, 3, 2 * CM, CM).astype(ft)
    # d(cat): the parity classes of the concat pixel over one e3 patch
    e3p = np.pad(e3.reshape(b, h4, w4, CM), ((0, 0), (0, 1), (0, 1), (0, 0)))
    dcat = np.zeros((b, h2, w2, 2 * CM), ft)
    for py in (0, 1):
        for px in (0, 1):
            ny, nx = len(range(py, h2, 2)), len(range(px, w2, 2))
            a_cols, b_rows = [], []
            for ky, dr in PARITY_TAPS[py].items():
                for kx, dc in PARITY_TAPS[px].items():
                    a_cols.append(e3p[:, dr:dr + ny, dc:dc + nx].reshape(-1,
                                                                         CM))
                    b_rows.append(k3[ky, kx].T)
            acc = mm(np.concatenate(a_cols, 1), np.concatenate(b_rows, 0))
            dcat[:, py::2, px::2] = acc.astype(ft).reshape(b, ny, nx, 2 * CM)
    # the concat's backward: BN2b's chain, the pool's routing
    z2b = y2b * g2b + b2b
    dpre2b = np.where(z2b > 0, dcat[..., CM:].reshape(-1, CM), 0).astype(ft)
    da1p = pool2x2_vjp(a1, dcat[..., :CM]).reshape(-1, CM)
    dsc2b, dbi2b, ds, dss = _bn_chain(
        _colsum(dpre2b * y2b).astype(ft), _colsum(dpre2b).astype(ft), sc[2],
        m2b, v2b, dmean[2], dvar[2], n1, ft)
    e2b = (dpre2b * g2b + ds + 2 * y2b * dss).astype(ft)
    out["dk2b"] = mm(col2b.T, e2b).reshape(2, 2, CM // 2, CM).astype(ft)
    # stem2b's dX from the taps up and left, B = k2b as stored
    kt = np.concatenate([k2b[dy, dx].T for dy in (0, 1) for dx in (0, 1)])
    da2a = mm(taps2x2(e2b.reshape(b, h2, w2, CM), True), kt).astype(ft)
    z2a = y2a * g2a + b2a
    dpre2a = np.where(z2a > 0, da2a, 0).astype(ft)
    dsc2a, dbi2a, ds, dss = _bn_chain(
        _colsum(dpre2a * y2a).astype(ft), _colsum(dpre2a).astype(ft), sc[1],
        m2a, v2a, dmean[1], dvar[1], n1, ft)
    e2a = (dpre2a * g2a + ds + 2 * y2a * dss).astype(ft)
    out["dk2a"] = mm(col2a.T, e2a).reshape(2, 2, CM, CM // 2).astype(ft)
    kt = np.concatenate([k2a[dy, dx].T for dy in (0, 1) for dx in (0, 1)])
    da1 = mm(taps2x2(e2a.reshape(b, h2, w2, CM // 2), True), kt).astype(ft)
    z1 = y1 * g1 + b1
    dpre1 = np.where(z1 > 0, (da1 + da1p).astype(ft), 0).astype(ft)
    dsc1, dbi1, ds, dss = _bn_chain(
        _colsum(dpre1 * y1).astype(ft), _colsum(dpre1).astype(ft), sc[0], m1,
        v1, dmean[0], dvar[0], n1, ft)
    e1 = (dpre1 * g1 + ds + 2 * y1 * dss).astype(ft)
    out["dk1"] = mm(col1.T, e1).reshape(3, 3, 3, CM).astype(ft)
    out.update(dsc1=dsc1, dbi1=dbi1, dsc2a=dsc2a, dbi2a=dbi2a, dsc2b=dsc2b,
               dbi2b=dbi2b)
    return out


@pytest.fixture(scope="module")
def runs():
    """Every route of every shape, eval and train, computed once."""
    out = {}
    for shape in SHAPES:
        d = _inputs(shape)
        for route in ROUTES:
            out[shape, route, True] = stem(d, route)
            out[shape, route, False] = stem(d, route, train=False)
    return out


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("shape", SHAPES)
def test_split_forward_holds_float64(runs, shape, train):
    """y3 (and the train statistics) of the 3x route within a tenth of the
    f32 bars of float64; one pass of TF32 at least 10x further off."""
    ref, r3, r1 = (runs[shape, k, train] for k in ("float64", "3x", "1x"))
    e3, e1 = _err(r3["y3"], ref["y3"]), _err(r1["y3"], ref["y3"])
    print(f"{shape} {'train' if train else 'eval'} y3 vs float64: 3x {e3}, "
          f"one pass {e1}")
    assert e3 <= 0.1 * Y3_BAR and e1 >= 10 * e3
    for k in STATS if train else ():
        assert _err(r3[k], ref[k]) <= 0.1 * SUM_BAR, k


@pytest.mark.parametrize("name", GRADS)
@pytest.mark.parametrize("shape", SHAPES)
def test_split_backward_holds_float64(runs, shape, name):
    """Each of K4-b's ten gradients of the 3x route within a third of
    K4B_TOL of float64 (the gradients of the three filters that the split
    kernels sum over pixels within a tenth)."""
    ref, r3, r1 = (runs[shape, k, True][name]
                   for k in ("float64", "3x", "1x"))
    e3, e1 = _err(r3, ref), _err(r1, ref)
    print(f"{shape} {name} vs float64: 3x {e3}, one pass {e1}")
    assert e3 <= (0.1 if name.startswith("dk") else 1 / 3) * GRAD_BAR


def test_one_pass_tf32_lies_over_the_gradient_bar(runs):
    """One pass of TF32 (hi*hi only) puts K4-b's worst gradient over
    K4B_TOL at every shape, so the bar tells the split from it; the 3x
    route's worst lies 10x under its own one-pass error."""
    for shape in SHAPES:
        ref, r3, r1 = (runs[shape, k, True] for k in ("float64", "3x", "1x"))
        e1 = max(_err(r1[k], ref[k]) for k in GRADS)
        e3 = max(_err(r3[k], ref[k]) for k in GRADS)
        print(f"{shape} K4-b worst gradient vs float64: 3x {e3}, one pass "
              f"{e1}")
        assert e1 > GRAD_BAR and e1 >= 10 * e3


def _torch_stem(d, train):
    t = torch.from_numpy
    params = [t(d["k1"]), t(d["sc"][0]), t(d["bi"][0]), t(d["k2a"]),
              t(d["sc"][1]), t(d["bi"][1]), t(d["k2b"]), t(d["sc"][2]),
              t(d["bi"][2]), t(d["k3"])]
    x = t(d["x"])
    if not train:
        return dict(y3=ST.stem_reference(
            x, *params, [t(m) for m in d["means"]],
            [t(v) for v in d["variances"]]).numpy())
    leaves = [p.clone().requires_grad_() for p in params]
    y3, means, variances = ST.stem_train_reference(x, *leaves)
    outs = (y3, *means, *variances)
    cots = (t(d["dy3"]), *(t(v) for v in d["dmeans"]),
            *(t(v) for v in d["dvars"]))
    grads = torch.autograd.grad(outs, leaves, cots)
    res = {k: v.detach().numpy() for k, v in zip(("y3", *STATS), outs)}
    res.update(zip(GRADS, (g.numpy() for g in grads)))
    return res


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("shape", SHAPES)
def test_float64_emulation_is_the_stem(runs, shape, train):
    """The decomposition computes the plain stem and the autograd of it
    (f32, so f32 tolerances: 1e-5 x max|ref| for y3 and the statistics,
    1e-4 for the gradients)."""
    ref = _torch_stem(_inputs(shape), train)
    emu = runs[shape, "float64", train]
    for k, v in ref.items():
        bar = 1e-4 if k in GRADS else 1e-5
        assert _err(v, emu[k]) <= bar, k


# The reference's Pallas stem takes H a multiple of 16 (and H / 4 at least
# one of its 8-row blocks) and W a multiple of 256
PALLAS_SHAPE = (1, 32, 256)


@pytest.fixture
def interpret_mode(monkeypatch):
    monkeypatch.setattr(PS, "_INTERPRET", True)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_split_stem_matches_the_pallas_stem(interpret_mode, train):
    """The 3x route against the reference's fused stem in f32 (interpreted
    Pallas), forward and, in train mode, the VJP for the same
    cotangents."""
    d = _inputs(PALLAS_SHAPE, seed=1)
    emu = stem(d, "3x", train)
    j = jnp.asarray
    params = (j(d["k1"]), j(d["sc"][0]), j(d["bi"][0]), j(d["k2a"]),
              j(d["sc"][1]), j(d["bi"][1]), j(d["k2b"]), j(d["sc"][2]),
              j(d["bi"][2]), j(d["k3"]))
    x = j(d["x"])
    if not train:
        y3 = PS.stem_fused_inference(
            x, *params, tuple(j(m) for m in d["means"]) + (j(np.zeros(CM)),),
            tuple(j(v) for v in d["variances"]) + (j(np.ones(CM)),),
            dtype=jnp.float32)
        assert _err(emu["y3"], np.asarray(y3)) <= 3e-3
        return

    def f(*p):
        return PS.stem_fused(x, *p, dtype=jnp.float32)
    (y3, means, variances), vjp = jax.vjp(f, *params)
    cots = (j(d["dy3"]), tuple(j(v) for v in d["dmeans"]),
            tuple(j(v) for v in d["dvars"]))
    grads = vjp(cots)
    assert _err(emu["y3"], np.asarray(y3)) <= 1e-4
    for k, o in zip(STATS, (*means, *variances)):
        np.testing.assert_allclose(emu[k], np.asarray(o), atol=1e-5,
                                   rtol=1e-4, err_msg=k)
    for k, g in zip(GRADS, grads):
        assert _err(emu[k], np.asarray(g)) <= 2e-3, k
