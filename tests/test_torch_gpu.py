"""Card-only tests of the port's CUDA kernels (marker ``gpu``).

Each skips without a CUDA card. This file imports no jax, so it also runs
on a machine that has none:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Every kernel is held against its plain PyTorch version on the same inputs:
f32 with cuDNN's TF32 off (tolerance 1e-4 x max|ref|, f32 sums in another
order), and bf16 inputs against the plain version in f32 on the same
bf16 values (1e-2 x max|ref|: the kernel rounds its output, and the front
its intermediate, to bf16). Shapes are ragged on purpose: tile, channel
and batch edges that the main path's shapes never hit.
"""

import math

import pytest
import torch

from robust_object_detection_tpu_torch.core.config import CorruptionConfig
from robust_object_detection_tpu_torch.ops import assignment as AS
from robust_object_detection_tpu_torch.ops import conv3x3 as C
from robust_object_detection_tpu_torch.ops import deform as DF
from robust_object_detection_tpu_torch.ops import fused_corrupt as FC
from robust_object_detection_tpu_torch.ops import nms as NM
from robust_object_detection_tpu_torch.ops import stem as ST
from robust_object_detection_tpu_torch.ops import yolo_front as TF

import _torch_nms_cases as NC  # noqa: E402

DTYPES = [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)]
# K2's odd shapes (B, H, W, C1, C2): odd H/4 and W/4 with channel counts
# that are not multiples of 8 (element staging), and a front wider than
# one channel slice or pass of the bf16 kernels (C1 64, C2 128)
FRONT_EDGES = [(1, 20, 36, 12, 20), (1, 18, 50, 64, 128)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _rand(gen, *shape, scale=1.0):
    return torch.randn(*shape, generator=gen) * scale


def _rel_err(out, ref):
    return ((out.float() - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("shape", [(1, 256, 256, 48, 48), (2, 37, 45, 5, 20),
                                   (3, 16, 16, 8, 16), (2, 37, 45, 24, 56),
                                   (1, 1, 17, 40, 20), (2, 9, 17, 40, 56)])
def test_conv3x3_kernel_matches_plain(cuda, dtype, tol, shape):
    b, h, w, cin, cout = shape
    g = torch.Generator().manual_seed(0)
    x = _rand(g, b, h, w, cin).to(cuda, dtype)
    k = _rand(g, 3, 3, cin, cout, scale=0.1).to(cuda, dtype)
    before = C.conv3x3.launches
    out = C.conv3x3(x, k)
    torch.cuda.synchronize()
    assert C.conv3x3.launches == before + 1
    assert out.shape == (b, h, w, cout) and out.dtype == dtype
    with torch.backends.cudnn.flags(allow_tf32=False):
        ref = C.conv3x3_reference(x.float(), k.float())
    assert _rel_err(out, ref) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("shape", [(1, 1024, 1024, 48, 96),
                                   (2, 34, 46, 16, 24)] + FRONT_EDGES)
def test_front_kernel_matches_plain(cuda, dtype, tol, shape):
    b, h, w, c1, c2 = shape
    g = torch.Generator().manual_seed(1)
    x = torch.rand(b, h, w, 3, generator=g).to(cuda, dtype)
    k1 = _rand(g, 3, 3, 3, c1, scale=0.2).to(cuda, dtype)
    k2 = _rand(g, 3, 3, c1, c2, scale=0.1).to(cuda, dtype)
    sc1 = (torch.rand(c1, generator=g) + 0.5).to(cuda)
    bi1 = _rand(g, c1, scale=0.1).to(cuda)
    means = (_rand(g, c1, scale=0.1).to(cuda), torch.zeros(c2, device=cuda))
    var = ((torch.rand(c1, generator=g) + 0.5).to(cuda),
           torch.ones(c2, device=cuda))
    before = TF.front_inference.launches
    out = TF.front_inference(x, k1, sc1, bi1, k2, means, var)
    torch.cuda.synchronize()
    assert TF.front_inference.launches == before + 1
    with torch.backends.cudnn.flags(allow_tf32=False):
        ref = TF.front_inference_reference(x.float(), k1.float(), sc1, bi1,
                                           k2.float(), means, var)
    assert out.shape == ref.shape
    assert _rel_err(out, ref) <= tol


@pytest.mark.gpu
def test_kernels_raise_on_cuda_tensors_they_do_not_take(cuda):
    x = torch.zeros(1, 8, 8, 4, device=cuda)
    k = torch.zeros(3, 3, 4, 4, device=cuda)
    before = C.conv3x3.launches
    with pytest.raises(ValueError, match="contiguous"):
        C.conv3x3(x[:, :, ::2], k)
    with pytest.raises(ValueError, match="dtype"):
        C.conv3x3(x.half(), k.half())
    with pytest.raises(ValueError, match="w on cpu"):
        C.conv3x3(x, k.cpu())
    assert C.conv3x3.launches == before
    img = torch.zeros(1, 9, 8, 3, device=cuda)
    kk = torch.zeros(3, 3, 3, 4, device=cuda)
    v = torch.ones(4, device=cuda)
    with pytest.raises(ValueError, match="even"):
        TF.front_inference(img, kk, v, v, torch.zeros(3, 3, 4, 4,
                                                      device=cuda),
                           (v, v), (v, v))


# ── training kernels: K3-b, K2-f train, K2-b, K1 ─────────────────────────

# K3-b x max|ref|. f32 1.5e-4, below one-pass TF32's error (the split
# kernel must keep its lo terms). bf16 1e-3: a product of two bf16 values
# is exact in f32, so the bf16 kernel differs from the f32 plain version on
# the same values only by the order of its f32 sums (2e-2 would pass a
# kernel that drops 1% of its pixels).
WGRAD_DTYPES = [(torch.float32, 1.5e-4), (torch.bfloat16, 1e-3)]
CONV3X3_EDGES = [(2, 37, 45, 24, 56), (1, 1, 17, 40, 20), (2, 9, 17, 40, 56)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", WGRAD_DTYPES)
@pytest.mark.parametrize("shape", [(2, 64, 64, 48, 48), (2, 37, 45, 5, 20),
                                   (1, 9, 30, 3, 17)] + CONV3X3_EDGES)
def test_conv3x3_backward_matches_plain(cuda, dtype, tol, shape):
    """dX through K3-f on the flipped filter, dW through K3-b, against the
    autograd of the plain conv in f32 on the same values; K3-b is
    deterministic (a second run gives identical bits)."""
    b, h, w, cin, cout = shape
    g = torch.Generator().manual_seed(2)
    x = _rand(g, b, h, w, cin).to(cuda, dtype).requires_grad_()
    k = _rand(g, 3, 3, cin, cout, scale=0.1).to(cuda).requires_grad_()
    dy = _rand(g, b, h, w, cout).to(cuda, dtype)
    before = (C.conv3x3.launches, C.conv3x3_wgrad.launches)
    C.conv3x3(x, k).backward(dy)
    torch.cuda.synchronize()
    assert (C.conv3x3.launches, C.conv3x3_wgrad.launches) == (
        before[0] + 2, before[1] + 1)
    assert x.grad.dtype == dtype and k.grad.dtype == torch.float32
    xr = x.detach().float().requires_grad_()
    kr = k.detach().to(dtype).float().requires_grad_()
    with torch.backends.cudnn.flags(allow_tf32=False):
        C.conv3x3_reference(xr, kr).backward(dy.float())
    assert _rel_err(x.grad, xr.grad) <= (1e-4 if dtype == torch.float32
                                         else 2e-2)
    assert _rel_err(k.grad, kr.grad) <= tol
    again = C.conv3x3_wgrad(x.detach(), dy)
    assert torch.equal(again, C.conv3x3_wgrad(x.detach(), dy))


def _misaligned(t):
    """A contiguous copy of t one element past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_conv3x3_misaligned_inputs_stage_by_element(cuda, dtype, tol):
    """A contiguous x (and dy) whose data pointer breaks 16-byte alignment
    takes the kernels' element staging (the plan says so) and still
    agrees with the plain versions: K3-f forward and dX, K3-b."""
    from robust_object_detection_tpu_torch import kernels
    b, h, w, cin, cout = 2, 37, 45, 48, 48
    g = torch.Generator().manual_seed(4)
    x = _misaligned(_rand(g, b, h, w, cin).to(cuda, dtype))
    dy = _misaligned(_rand(g, b, h, w, cout).to(cuda, dtype))
    k = _rand(g, 3, 3, cin, cout, scale=0.1).to(cuda, dtype)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    sm = kernels.sm_count(cuda)
    name = str(dtype).split(".")[-1]
    fw = kernels.conv3x3_tc_plan(name, b, h, w, cin, cout,
                                 (x.data_ptr(), k.data_ptr()), sm)
    wg = kernels.wgrad_tc_plan(name, b, h, w, cin, cout,
                               (x.data_ptr(), dy.data_ptr()), sm)
    assert fw["vec"] == 0 and wg["vec"] == 0
    kflip = k.flip(0, 1).transpose(2, 3).contiguous()
    with torch.backends.cudnn.flags(allow_tf32=False):
        assert _rel_err(C.conv3x3(x, k),
                        C.conv3x3_reference(x.float(), k.float())) <= tol
        assert _rel_err(C.conv3x3(dy, kflip), C.conv3x3_reference(
            dy.float(), kflip.float())) <= tol
        dk = C.conv3x3_wgrad(x, dy)
        assert _rel_err(dk, C.conv3x3_wgrad_reference(x.float(),
                                                      dy.float())) <= (
            1.5e-4 if dtype == torch.float32 else 1e-3)
    assert torch.equal(dk, C.conv3x3_wgrad(x, dy))


# the f32 route's odd shapes: channel counts of 3 and 5 (element staging),
# 24, 40 and 56 (two output-channel slices, two input-channel passes), H 1
# and W 17 (ragged tiles)
F32_EDGES = [(2, 37, 45, 5, 20), (1, 9, 30, 3, 17), (2, 37, 45, 24, 56),
             (1, 1, 17, 40, 20), (2, 19, 17, 56, 24)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", F32_EDGES)
def test_conv3x3_f32_split_tf32_holds_float64(cuda, shape):
    """K3's f32 route (split TF32 on the tensor cores): K3-f, K3-f as dX
    and K3-b against float64 on the same f32 values, at 1e-5 x max|ref|, a
    tenth of the f32 checks' bar (one pass of TF32 is near 3e-4)."""
    b, h, w, cin, cout = shape
    g = torch.Generator().manual_seed(6)
    x = _rand(g, b, h, w, cin).to(cuda)
    dy = _rand(g, b, h, w, cout).to(cuda)
    k = _rand(g, 3, 3, cin, cout, scale=0.1).to(cuda)
    kflip = k.flip(0, 1).transpose(2, 3).contiguous()
    assert _rel_err(C.conv3x3(x, k),
                    C.conv3x3_reference(x.double(), k.double())) <= 1e-5
    assert _rel_err(C.conv3x3(dy, kflip), C.conv3x3_reference(
        dy.double(), kflip.double())) <= 1e-5
    assert _rel_err(C.conv3x3_wgrad(x, dy), C.conv3x3_wgrad_reference(
        x.double(), dy.double()).double()) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("bad", [math.inf, -math.inf, math.nan])
def test_conv3x3_f32_non_finite_input(cuda, bad):
    """A non-finite x through the f32 route, with a random filter and one
    of TF32 values: Inf, -Inf and NaN outputs exactly where the float64
    conv has them (the split puts a non-finite value in lo with hi 0)."""
    g = torch.Generator().manual_seed(7)
    x = _rand(g, 1, 9, 17, 8)
    x[0, 4, 5, 3] = bad
    k = _rand(g, 3, 3, 8, 16, scale=0.1)
    k = torch.cat([k, (k.view(torch.int32) & -8192).view(torch.float32)], -1)
    out = C.conv3x3(x.to(cuda), k.contiguous().to(cuda)).cpu()
    ref = C.conv3x3_reference(x.double(), k.double())
    assert torch.isfinite(out).sum() == torch.isfinite(ref).sum() > 0
    for test in (torch.isnan, torch.isposinf, torch.isneginf):
        assert torch.equal(test(out), test(ref))


def _front_inputs(g, b, h, w, c1, c2, device):
    x = torch.rand(b, h, w, 3, generator=g).to(device)
    k1 = _rand(g, 3, 3, 3, c1, scale=0.2).to(device)
    k2 = _rand(g, 3, 3, c1, c2, scale=0.1).to(device)
    sc1 = (torch.rand(c1, generator=g) + 0.5).to(device)
    bi1 = _rand(g, c1, scale=0.1).to(device)
    return x, k1, sc1, bi1, k2


def _front_loss(out, c2):
    """Every output of the front feeds the loss (y2 through a BN2 + SiLU,
    as the model uses it; the statistics directly, as tests/
    test_pallas_yolo_front.py does)."""
    y2, m1, v1, m2, v2 = out
    wts = torch.arange(y2.numel(), device=y2.device).view(y2.shape) % 7 - 3
    a2 = torch.nn.functional.silu((y2.float() - m2) * torch.rsqrt(v2 + 1e-3))
    return ((a2 * wts).sum() + 0.1 * m1.sum() + 0.1 * v1.sum()
            + 0.05 * (m2 * v2).sum())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", [(2, 64, 64, 48, 96), (2, 34, 46, 16, 24)]
                         + FRONT_EDGES)
def test_front_train_forward_matches_plain(cuda, dtype, tol, shape):
    b, h, w, c1, c2 = shape
    x, k1, sc1, bi1, k2 = _front_inputs(torch.Generator().manual_seed(3),
                                        b, h, w, c1, c2, cuda)
    before = TF.front_fused.launches
    out = TF.front_fused(x.to(dtype), k1, sc1, bi1, k2)
    torch.cuda.synchronize()
    assert TF.front_fused.launches == before + 1
    with torch.backends.cudnn.flags(allow_tf32=False):
        ref = TF.front_fused_reference(x.to(dtype).float(),
                                       k1.to(dtype).float(), sc1, bi1,
                                       k2.to(dtype).float())
    assert out[0].shape == ref[0].shape and out[0].dtype == dtype
    assert _rel_err(out[0], ref[0]) <= tol
    for o, r in zip(out[1:], ref[1:]):
        assert _rel_err(o, r) <= (1e-3 if dtype == torch.float32 else tol)


# K2-b's gradients x max|ref| (chip_smoke.K2B_TOL): f32 1.5e-4, below one
# pass of TF32's error (the split kernels must keep their lo terms)
@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1.5e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", [(2, 64, 64, 48, 96), (2, 34, 46, 16, 24)]
                         + FRONT_EDGES)
def test_front_train_backward_matches_plain(cuda, dtype, tol, shape):
    """K2-b against the autograd of the plain front in the same dtype (f32
    with TF32 off; bf16, which rounds y1 where the kernel does — see
    chip_smoke.phase_train_kernels): every parameter's gradient within
    tol x max|ref| (sums over B x H x W)."""
    b, h, w, c1, c2 = shape
    args = _front_inputs(torch.Generator().manual_seed(4), b, h, w, c1, c2,
                         cuda)
    x = args[0].to(dtype)
    params = [t.clone().requires_grad_() for t in args[1:]]
    before = TF.front_fused_backward.launches
    _front_loss(TF.front_fused(x, *params), c2).backward()
    torch.cuda.synchronize()
    assert TF.front_fused_backward.launches == before + 1
    ref_params = [t.clone().requires_grad_() for t in args[1:]]
    with torch.backends.cudnn.flags(allow_tf32=False):
        _front_loss(TF.front_fused_reference(x, *ref_params), c2).backward()
    for p, r in zip(params, ref_params):
        assert _rel_err(p.grad, r.grad) <= tol


@pytest.mark.gpu
def test_front_misaligned_x_stages_by_element(cuda):
    """A contiguous bf16 x whose data pointer breaks 16-byte alignment
    takes element staging in P1 and dk1 (the plans say so) and still agrees
    with the plain front: eval, train forward and K2-b."""
    from robust_object_detection_tpu_torch import kernels
    b, h, w, c1, c2 = 2, 64, 64, 48, 96
    args = _front_inputs(torch.Generator().manual_seed(6), b, h, w, c1, c2,
                         cuda)
    x = _misaligned(args[0].bfloat16())
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    k1, sc1, bi1, k2 = args[1:]
    sm = kernels.sm_count(cuda)
    k1b, k2b = k1.bfloat16(), k2.bfloat16()
    plan = kernels.front_plan("bfloat16", b, h, w, c1, c2,
                              (x.data_ptr(), k1b.data_ptr(), k2b.data_ptr()),
                              sm)
    assert (plan["p1"]["vec"], plan["p2"]["vec"]) == (0, 1)
    means = (torch.zeros(c1, device=cuda), torch.zeros(c2, device=cuda))
    var = (torch.ones(c1, device=cuda), torch.ones(c2, device=cuda))
    with torch.backends.cudnn.flags(allow_tf32=False):
        assert _rel_err(TF.front_inference(x, k1b, sc1, bi1, k2b, means, var),
                        TF.front_inference_reference(
                            x.float(), k1b.float(), sc1, bi1, k2b.float(),
                            means, var)) <= 1e-2
    params = [t.clone().requires_grad_() for t in args[1:]]
    ref_params = [t.clone().requires_grad_() for t in args[1:]]
    out = TF.front_fused(x, *params)
    ref = TF.front_fused_reference(x, *ref_params)
    for o, r in zip(out, ref):
        assert _rel_err(o, r) <= 2e-2
    _front_loss(out, c2).backward()
    _front_loss(ref, c2).backward()
    for p, r in zip(params, ref_params):
        assert _rel_err(p.grad, r.grad) <= 2e-2


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 64, 64, 48, 96), (2, 34, 46, 16, 24),
                                   (1, 20, 36, 12, 20)])
def test_front_train_is_deterministic(cuda, shape):
    """The bf16 train-mode statistics and every gradient of K2-b are the
    same bits on a second run (fixed-order partials, no atomics)."""
    b, h, w, c1, c2 = shape
    args = _front_inputs(torch.Generator().manual_seed(7), b, h, w, c1, c2,
                         cuda)
    x = args[0].bfloat16()
    runs = []
    for _ in range(2):
        params = [t.clone().requires_grad_() for t in args[1:]]
        out = TF.front_fused(x, *params)
        _front_loss(out, c2).backward()
        runs.append([t.detach() for t in out] + [p.grad for p in params])
    assert all(torch.equal(a, r) for a, r in zip(*runs))


def _front64(x, k1, sc1, bi1, k2, train=True, running=None):
    """The front in float64 (flax's fast variance in train mode; BN1 from
    `running` (mean1, var1) in eval mode), differentiable."""
    F = torch.nn.functional
    x, k1, sc1, bi1, k2 = (t.double() for t in (x, k1, sc1, bi1, k2))

    def stats(y):
        m = y.mean((0, 2, 3))
        return m, torch.clamp((y * y).mean((0, 2, 3)) - m * m, min=0.0)
    y1 = F.conv2d(x.permute(0, 3, 1, 2), k1.permute(3, 2, 0, 1), stride=2,
                  padding=1)
    m1, v1 = stats(y1) if train else (t.double() for t in running)
    g1 = sc1 * torch.rsqrt(v1 + 1e-3)
    b1 = bi1 - m1 * g1
    a1 = F.silu(y1 * g1[:, None, None] + b1[:, None, None])
    y2 = F.conv2d(a1, k2.permute(3, 2, 0, 1), stride=2, padding=1)
    if not train:
        return y2.permute(0, 2, 3, 1)
    m2, v2 = stats(y2)
    return y2.permute(0, 2, 3, 1), m1, v1, m2, v2


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 34, 46, 16, 24), (2, 26, 30, 10, 14)]
                         + FRONT_EDGES)
def test_front_f32_matches_float64(cuda, shape):
    """K2's f32 route (split TF32) against the front in float64 at odd
    shapes (odd H/4 and W/4; C1, C2 not multiples of 4 or 8; a front wider
    than one slice): eval and train y2 and the statistics within 1e-5 x
    max|ref|, K2-b's gradients for random cotangents within 1e-4 (one pass
    of TF32 would be ~5e-4 off: tests/test_torch_front_tf32.py); K2-b and
    the statistics the same bits twice."""
    b, h, w, c1, c2 = shape
    g = torch.Generator().manual_seed(8)
    args = _front_inputs(g, b, h, w, c1, c2, cuda)
    x = args[0]
    running = ((_rand(g, c1, scale=0.1)).to(cuda),
               (torch.rand(c1, generator=g) + 0.5).to(cuda))
    means = (running[0], torch.zeros(c2, device=cuda))
    var = (running[1], torch.ones(c2, device=cuda))
    out = TF.front_inference(x, args[1], args[2], args[3], args[4], means,
                             var)
    ref = _front64(*args, train=False, running=running)
    assert _rel_err(out.double(), ref) <= 1e-5

    cots = (_rand(g, b, -(-(h // 2) // 2), -(-(w // 2) // 2), c2).to(cuda),
            *(_rand(g, c, scale=0.1).to(cuda) for c in (c1, c1, c2, c2)))
    runs = []
    for _ in range(2):
        params = [t.clone().requires_grad_() for t in args[1:]]
        outs = TF.front_fused(x, *params)
        grads = torch.autograd.grad(outs, params, cots)
        runs.append([t.detach() for t in outs] + list(grads))
    assert all(torch.equal(a, r) for a, r in zip(*runs))
    ref_params = [t.double().requires_grad_() for t in args[1:]]
    refs = _front64(x, *ref_params)
    ref_grads = torch.autograd.grad(refs, ref_params,
                                    [c.double() for c in cots])
    for o, r in zip(runs[0][:5], refs):
        assert _rel_err(o.double(), r.detach()) <= 1e-5
    for o, r in zip(runs[0][5:], ref_grads):
        assert _rel_err(o.double(), r) <= 1e-4


@pytest.mark.gpu
def test_front_f32_misaligned_x_stages_by_element(cuda):
    """An f32 x one element past a 16-byte line, and W not a multiple of 4
    (12-byte pixels), take element staging in P1 and dk1 (the plans say
    so) and still agree with the plain front."""
    from robust_object_detection_tpu_torch import kernels
    sm = kernels.sm_count(cuda)
    for b, h, w, c1, c2, shift in ((2, 64, 64, 48, 96, True),
                                   (1, 20, 38, 48, 96, False)):
        args = _front_inputs(torch.Generator().manual_seed(9), b, h, w, c1,
                             c2, cuda)
        x = _misaligned(args[0]) if shift else args[0]
        k1, sc1, bi1, k2 = args[1:]
        plan = kernels.front_plan("float32", b, h, w, c1, c2,
                                  (x.data_ptr(), k1.data_ptr(),
                                   k2.data_ptr()), sm)
        bplan = kernels.front_bwd_plan(
            "float32", b, h, w, c1, c2, (x.data_ptr(), k2.data_ptr(), 0, 0,
                                         0), sm)
        assert (plan["p1"]["vec"], plan["p2"]["vec"]) == (0, 1)
        assert (bplan["vec"], bplan["vec_x"]) == (1, 0)
        means = (torch.zeros(c1, device=cuda), torch.zeros(c2, device=cuda))
        var = (torch.ones(c1, device=cuda), torch.ones(c2, device=cuda))
        with torch.backends.cudnn.flags(allow_tf32=False):
            assert _rel_err(TF.front_inference(x, k1, sc1, bi1, k2, means,
                                               var),
                            TF.front_inference_reference(
                                x, k1, sc1, bi1, k2, means, var)) <= 1e-4
            params = [t.clone().requires_grad_() for t in args[1:]]
            ref_params = [t.clone().requires_grad_() for t in args[1:]]
            out = TF.front_fused(x, *params)
            ref = TF.front_fused_reference(x, *ref_params)
            for o, r, tol in zip(out, ref, (1e-4, 1e-3, 1e-3, 1e-3, 1e-3)):
                assert _rel_err(o, r) <= tol
            _front_loss(out, c2).backward()
            _front_loss(ref, c2).backward()
        for p, r in zip(params, ref_params):
            assert _rel_err(p.grad, r.grad) <= 1e-3


@pytest.mark.gpu
def test_corrupt_kernel_matches_plain(cuda):
    """K1 against its plain version on one batch with all four branches:
    clean and blur bit-exact, lowres and noise within 1 LSB; the noise of
    a mid-grey image has mean -0.5 +- 0.5 (truncating to integers takes
    0.5 off) and std 15 +- 0.5."""
    g = torch.Generator().manual_seed(5)
    img = torch.floor(torch.rand(4, 64, 96, 3, generator=g) * 256)
    img[1] = 128.0
    choice = torch.tensor([0, 1, 2, 3], dtype=torch.int32)
    seeds = torch.tensor([11, 22, 33, 44], dtype=torch.int32)
    before = FC.fused_random_corruption.launches
    out, _ = FC.fused_random_corruption(img.to(cuda), None, choice=choice,
                                        seeds=seeds)
    torch.cuda.synchronize()
    assert FC.fused_random_corruption.launches == before + 1
    ref = FC.fused_corruption_reference(img, choice, seeds)
    out = out.cpu()
    assert torch.equal(out[0], ref[0]) and torch.equal(out[2], ref[2])
    assert (out[1] - ref[1]).abs().max() <= 1
    assert (out[3] - ref[3]).abs().max() <= 1
    noise = out[1] - 128.0
    assert abs(noise.mean().item() + 0.5) <= 0.5
    assert abs(noise.std().item() - 15.0) <= 0.5


@pytest.mark.gpu
@pytest.mark.parametrize("shape,blur_k,misalign", [
    ((4, 18, 70, 3), 9, False),      # W * C = 210: element route, ragged
    ((4, 34, 130, 4), 9, False),     # 16-byte route, ragged tiles, C 4
    ((4, 40, 136, 3), 9, True),      # x one element past a 16-byte line
    ((4, 32, 64, 3), 15, False),     # a wider blur
    ((4, 8, 8, 1), 3, False)])
def test_corrupt_tiles_match_plain_at_odd_shapes(cuda, shape, blur_k,
                                                 misalign):
    """K1's tile grid at shapes the path never gives it: clean and blur
    bit-exact, noise and lowres within 1, every branch in one launch."""
    g = torch.Generator().manual_seed(6)
    img = torch.floor(torch.rand(*shape, generator=g) * 256)
    cfg = CorruptionConfig(blur_kernel=blur_k)
    choice = torch.tensor([0, 1, 2, 3], dtype=torch.int32)
    seeds = torch.tensor([7, 8, 9, 10], dtype=torch.int32)
    x = img.to(cuda)
    if misalign:
        x = _misaligned(x)
        assert x.data_ptr() % 16 != 0
    before = FC.fused_random_corruption.launches
    out, _ = FC.fused_random_corruption(x, None, cfg, choice, seeds)
    torch.cuda.synchronize()
    assert FC.fused_random_corruption.launches == before + 1
    ref = FC.fused_corruption_reference(img, choice, seeds, cfg)
    out = out.cpu()
    assert torch.equal(out[0], ref[0]) and torch.equal(out[2], ref[2])
    assert (out[1] - ref[1]).abs().max() <= 1
    assert (out[3] - ref[3]).abs().max() <= 1


@pytest.mark.gpu
def test_training_kernels_raise_on_cuda_tensors_they_do_not_take(cuda):
    x = torch.zeros(1, 8, 8, 4, device=cuda)
    before = (C.conv3x3_wgrad.launches, TF.front_fused.launches,
              FC.fused_random_corruption.launches)
    with pytest.raises(ValueError, match="dtype"):
        C.conv3x3_wgrad(x, x.half())
    with pytest.raises(ValueError, match="contiguous"):
        C.conv3x3_wgrad(x[:, :, ::2], x[:, :, ::2])
    img = torch.zeros(1, 10, 8, 3, device=cuda)
    kk, v = torch.zeros(3, 3, 3, 4, device=cuda), torch.ones(4, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        TF.front_fused(img.half(), kk, v, v,
                       torch.zeros(3, 3, 4, 4, device=cuda))
    with pytest.raises(ValueError, match="even"):
        FC.fused_random_corruption(torch.zeros(1, 9, 8, 3, device=cuda),
                                   None, CorruptionConfig(), [0], [0])
    assert (C.conv3x3_wgrad.launches, TF.front_fused.launches,
            FC.fused_random_corruption.launches) == before


# ── RT-DETR-L serving kernels: K4-f, K5 forward ──────────────────────────

def _stem_inputs(g, b, h, w, device, dtype):
    cm = 32
    x = torch.rand(b, h, w, 3, generator=g).to(device, dtype)
    ks = [_rand(g, *shape, scale=sc).to(device, dtype) for shape, sc in (
        ((3, 3, 3, cm), 0.2), ((2, 2, cm, cm // 2), 0.2),
        ((2, 2, cm // 2, cm), 0.2), ((3, 3, 2 * cm, cm), 0.1))]
    sizes = (cm, cm // 2, cm)
    sc = [(torch.rand(c, generator=g) + 0.5).to(device) for c in sizes]
    bi = [_rand(g, c, scale=0.1).to(device) for c in sizes]
    means = [_rand(g, c, scale=0.1).to(device) for c in sizes]
    var = [(torch.rand(c, generator=g) + 0.5).to(device) for c in sizes]
    return (x, ks[0], sc[0], bi[0], ks[1], sc[1], bi[1], ks[2], sc[2], bi[2],
            ks[3], means, var)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", [(1, 1024, 1024), (2, 36, 52), (3, 4, 8)])
def test_stem_kernel_matches_plain(cuda, dtype, tol, shape):
    """K4-f against the plain chain in f32 on the same values (bf16: the
    kernel stores a1, a2a, a2b and y3 in bf16, three roundings deep)."""
    b, h, w = shape
    args = _stem_inputs(torch.Generator().manual_seed(6), b, h, w, cuda,
                        dtype)
    before = ST.stem_fused_inference.launches
    out = ST.stem_fused_inference(*args)
    torch.cuda.synchronize()
    assert ST.stem_fused_inference.launches == before + 1
    assert out.shape == (b, h // 4, w // 4, 32) and out.dtype == dtype
    with torch.backends.cudnn.flags(allow_tf32=False):
        ref = ST.stem_reference(*(a.float() if torch.is_tensor(a) else a
                                  for a in args))
    assert _rel_err(out, ref) <= tol


def _deform_inputs(g, shapes, b, q, heads, dh, p, device, dtype, lo=-0.2,
                   hi=1.2):
    hw = sum(h * w for h, w in shapes)
    n_l = len(shapes)
    values = _rand(g, b, hw, heads, dh).to(device, dtype)
    loc = (torch.rand(b, q, heads, n_l, p, 2, generator=g) * (hi - lo)
           + lo).to(device)
    attn = torch.softmax(_rand(g, b, q, heads, n_l * p), -1).reshape(
        b, q, heads, n_l, p).to(device)
    return values, shapes, loc, attn


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("case", [
    (((128, 128), (64, 64), (32, 32)), 2, 300, 8, 32, 4),
    (((6, 10), (3, 5)), 1, 7, 3, 32, 2),
    (((5, 7), (3, 3), (2, 1), (1, 1)), 2, 13, 2, 8, 8),
    (((9, 4),), 1, 5, 1, 48, 3)])
def test_deform_kernel_matches_plain(cuda, dtype, tol, case):
    """K5 forward against the plain gather version in f32 on the same
    values (f32: the same products, another summation order; bf16: one
    rounding of the f32 sum), taps outside the maps included."""
    shapes, b, q, heads, dh, p = case
    values, shapes, loc, attn = _deform_inputs(
        torch.Generator().manual_seed(7), shapes, b, q, heads, dh, p, cuda,
        dtype)
    before = DF.ms_deform_attn_slots.launches
    out = DF.ms_deform_attn_slots(values, shapes, loc, attn)
    torch.cuda.synchronize()
    assert DF.ms_deform_attn_slots.launches == before + 1
    assert out.shape == (b, q, heads, dh) and out.dtype == dtype
    ref = DF.ms_deform_attn_ref(values.float(), shapes, loc, attn)
    assert _rel_err(out, ref) <= tol
    perm = torch.randperm(q, generator=torch.Generator().manual_seed(0))
    outp = DF.ms_deform_attn_slots(values, shapes, loc[:, perm].contiguous(),
                                   attn[:, perm].contiguous())
    assert torch.equal(outp, out[:, perm])      # any query order, same bits


@pytest.mark.gpu
def test_rtdetr_kernels_raise_on_cuda_tensors_they_do_not_take(cuda):
    g = torch.Generator().manual_seed(8)
    args = _stem_inputs(g, 1, 8, 8, cuda, torch.float32)
    values, shapes, loc, attn = _deform_inputs(
        g, ((4, 4), (2, 2)), 1, 3, 2, 8, 2, cuda, torch.float32)
    before = (ST.stem_fused_inference.launches,
              DF.ms_deform_attn_slots.launches)
    with pytest.raises(ValueError, match="multiples of 4"):
        ST.stem_fused_inference(args[0][:, :6], *args[1:])
    with pytest.raises(ValueError, match="dtype"):
        ST.stem_fused_inference(args[0].half(), *args[1:])
    with pytest.raises(ValueError, match="device"):
        ST.stem_fused_inference(args[0], args[1].cpu(), *args[2:])
    with pytest.raises(ValueError, match="float32 loc"):
        DF.ms_deform_attn_slots(values.half(), shapes, loc, attn)
    with pytest.raises(ValueError, match="contiguous"):
        DF.ms_deform_attn_slots(values, shapes, loc.transpose(1, 2)
                                .contiguous().transpose(1, 2), attn)
    with pytest.raises(ValueError, match="CUDA card"):
        DF.ms_deform_attn_backward(values.cpu(), shapes, loc.cpu(),
                                   attn.cpu(), values.cpu()[:, :3])
    DF.ms_deform_attn_slots(values, shapes, loc, attn)
    assert (ST.stem_fused_inference.launches,
            DF.ms_deform_attn_slots.launches) == (before[0], before[1] + 1)


@pytest.mark.gpu
def test_create_without_a_device_lands_on_the_card(cuda):
    from robust_object_detection_tpu_torch.models import rtdetr as TR
    from robust_object_detection_tpu_torch.models import yolov8 as TY
    for model in (TY.create(6, "n"), TR.create(6)):
        assert {p.device.type for p in model.parameters()} == {"cuda"}
        assert not model.training


def _forward_with_anchor_ids(model, x):
    """(outputs, the anchor index of every selected query (B, Q)), the
    latter read off the encoder score head with a hook."""
    from robust_object_detection_tpu_torch.models import rtdetr as TR
    seen = []
    dec = model.model[28]
    hook = dec.enc_score_head.register_forward_hook(
        lambda mod, args, out: seen.append(out))
    try:
        outs = model(x)
    finally:
        hook.remove()
    size = x.shape[1]
    _, valid = TR.build_anchors([(size // s, size // s) for s in (8, 16, 32)])
    scores = seen[0].amax(-1).masked_fill(
        ~torch.from_numpy(valid).to(x.device), -1e4)
    return outs, TR.top_k(scores, min(dec.cfg.queries, scores.shape[1]))[1]


@pytest.mark.gpu
def test_rtdetr_forward_goes_through_the_kernels(cuda):
    """One f32 RT-DETR-L forward at 128 px on the card: 1 stem, 6 conv3x3
    and 6 deformable-attention launches; the same anchors selected as with
    the same weights on the CPU (plain versions), and, query matched to
    query by its anchor (near-tied encoder scores may swap rows), every
    layer's logits and boxes within 2e-3 x max|ref|."""
    from robust_object_detection_tpu_torch.models import rtdetr as TR
    gpu = TR.create(6, generator=torch.Generator().manual_seed(0))
    cpu = TR.create(6, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    x = torch.rand(2, 128, 128, 3, generator=torch.Generator().manual_seed(1))
    counters = (ST.stem_fused_inference, C.conv3x3, DF.ms_deform_attn_slots)
    before = [f.launches for f in counters]
    with torch.no_grad(), torch.backends.cudnn.flags(allow_tf32=False):
        out, sel = _forward_with_anchor_ids(gpu, x.to(cuda))
        ref, rsel = _forward_with_anchor_ids(cpu, x)
    assert [f.launches - n for f, n in zip(counters, before)] == [1, 6, 6]
    sel = sel.cpu()
    for b in range(2):
        assert set(sel[b].tolist()) == set(rsel[b].tolist())
        rows, rrows = torch.argsort(sel[b]), torch.argsort(rsel[b])
        for k in ("logits", "boxes"):
            assert _rel_err(out[k][:, b].cpu()[:, rows],
                            ref[k][:, b][:, rrows]) <= 2e-3, k
        for k in ("enc_logits", "enc_boxes"):
            assert _rel_err(out[k][b].cpu()[rows], ref[k][b][rrows]) <= 2e-3


# ── RT-DETR-L training kernels: K4-f train, K4-b, K5 backward, K6 ────────

def _stem_train_inputs(g, b, h, w, device):
    args = _stem_inputs(g, b, h, w, device, torch.float32)
    return args[0], [t for t in args[1:11]]


def _stem_loss(out):
    """Every output of the train-mode stem feeds the loss (y3 through BN3 +
    ReLU as the model uses it, the statistics directly, as
    tests/test_pallas_stem.py does), so every statistics cotangent of K4-b
    is exercised."""
    y3, means, variances = out
    wts = (torch.arange(y3.numel(), device=y3.device).view(y3.shape) % 7
           - 3).float()
    a3 = torch.relu((y3.float() - means[3]) * torch.rsqrt(variances[3]
                                                          + 1e-3))
    loss = (a3 * wts).mean()
    for i, (m, v) in enumerate(zip(means, variances)):
        loss = loss + 0.1 * (i + 1) * m.sum() + 0.05 * (i + 1) * (v * v).sum()
    return loss


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", [(2, 256, 256), (2, 36, 52), (3, 4, 8)])
def test_stem_train_forward_matches_plain(cuda, dtype, tol, shape):
    """K4-f train against the plain chain in f32 on the same values: y3
    within tol x max|ref| (bf16: four stored tensors deep), the eight batch
    statistics within 1e-3 (f32) or tol; a second run gives the same
    bits."""
    b, h, w = shape
    x, params = _stem_train_inputs(torch.Generator().manual_seed(9), b, h, w,
                                   cuda)
    before = ST.stem_fused.launches
    y3, means, variances = ST.stem_fused(x.to(dtype), *params)
    torch.cuda.synchronize()
    assert ST.stem_fused.launches == before + 1
    assert y3.shape == (b, h // 4, w // 4, 32) and y3.dtype == dtype
    rparams = [p.to(dtype).float() if p.dim() == 4 else p for p in params]
    with torch.backends.cudnn.flags(allow_tf32=False):
        ry3, rmeans, rvars = ST.stem_train_reference(x.to(dtype).float(),
                                                     *rparams)
    assert _rel_err(y3, ry3) <= tol
    for o, r in zip((*means, *variances), (*rmeans, *rvars)):
        assert _rel_err(o, r) <= (1e-3 if dtype == torch.float32 else tol)
    again = ST.stem_fused(x.to(dtype), *params)
    assert torch.equal(again[0], y3)
    assert all(torch.equal(a, m) for a, m in zip(again[1], means))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3),
                                       (torch.bfloat16, 8e-2)])
@pytest.mark.parametrize("shape", [(2, 128, 128), (2, 36, 52)])
def test_stem_train_backward_matches_plain(cuda, dtype, tol, shape):
    """K4-b against the autograd of the plain chain in the same dtype (f32
    with TF32 off; bf16, which rounds the stored tensors where the kernels
    do): each of the ten gradients within tol x max|ref| (sums over B x H x
    W; in bf16 a last-bit difference of a stored y flips roundings four
    tensors down the chain, 4.4% on dk1 at 936 pixels); a second run gives
    identical bits (no atomics)."""
    b, h, w = shape
    x, params = _stem_train_inputs(torch.Generator().manual_seed(10), b, h,
                                   w, cuda)
    x = x.to(dtype)
    ps = [p.clone().requires_grad_() for p in params]
    before = ST.stem_fused_backward.launches
    _stem_loss(ST.stem_fused(x, *ps)).backward()
    torch.cuda.synchronize()
    assert ST.stem_fused_backward.launches == before + 1
    rs = [p.clone().requires_grad_() for p in params]
    with torch.backends.cudnn.flags(allow_tf32=False):
        _stem_loss(ST.stem_train_reference(x, *rs)).backward()
    for i, (p, r) in enumerate(zip(ps, rs)):
        assert _rel_err(p.grad, r.grad) <= tol, i
    ps2 = [p.clone().requires_grad_() for p in params]
    _stem_loss(ST.stem_fused(x, *ps2)).backward()
    assert all(torch.equal(a.grad, c.grad) for a, c in zip(ps, ps2))


def _stem_bf16_all_modes(x, params, cuda, gtol):
    """The bf16 stem kernels on x against their plain versions: eval (2e-2
    x max|ref| against the f32 chain on the same values), train y3 and the
    eight statistics (2e-2), K4-b's ten gradients (gtol, against the
    autograd of the plain chain in bf16); the train outputs and K4-b bit-
    identical on a second run."""
    b, h, w, _ = x.shape
    sizes = (32, 16, 32)
    means = [torch.zeros(c, device=cuda) for c in sizes]
    var = [torch.ones(c, device=cuda) for c in sizes]
    ev = [x, *(p.bfloat16() if p.dim() == 4 else p for p in params), means,
          var]
    out = ST.stem_fused_inference(*ev)
    with torch.backends.cudnn.flags(allow_tf32=False):
        ref = ST.stem_reference(*(a.float() if torch.is_tensor(a) else a
                                  for a in ev))
    assert out.shape == (b, h // 4, w // 4, 32)
    assert _rel_err(out, ref) <= 2e-2
    runs = []
    for _ in range(2):
        ps = [p.clone().requires_grad_() for p in params]
        y3, ms, vs = ST.stem_fused(x, *ps)
        _stem_loss((y3, ms, vs)).backward()
        runs.append([y3.detach(), *ms, *vs] + [p.grad for p in ps])
    assert all(torch.equal(a, r) for a, r in zip(*runs))
    rs = [p.clone().requires_grad_() for p in params]
    with torch.backends.cudnn.flags(allow_tf32=False):
        ry3, rms, rvs = ST.stem_train_reference(x, *rs)
        _stem_loss((ry3, rms, rvs)).backward()
    for o, r in zip(runs[0][:9], (ry3, *rms, *rvs)):
        assert _rel_err(o, r.detach()) <= 2e-2
    for i, (g, r) in enumerate(zip(runs[0][9:], rs)):
        assert _rel_err(g, r.grad) <= gtol, i


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 20, 44), (3, 12, 28), (2, 44, 20)])
def test_stem_bf16_odd_shapes(cuda, shape):
    """K4-f eval, train and K4-b on the tensor-core route at shapes the
    path never gives them: H != W, H/4 and W/4 odd, W not a multiple of 8
    (stem1 and dk1 stage x by element), ragged tiles, small B. K4-b at
    0.25 x max|ref|, chip_smoke.py's tolerance at its odd bf16 shape: the
    sums run over 110 to 440 stem2 pixels, where a last-bit difference of
    a stored y (the kernels round an f32 sum once, cuDNN's bf16 conv
    elsewhere) flips roundings down the chain; the CUDA-core route shows
    the same errors against the plain chain on these inputs (up to 0.15
    at 252 pixels)."""
    from robust_object_detection_tpu_torch import kernels
    b, h, w = shape
    x, params = _stem_train_inputs(torch.Generator().manual_seed(15), b, h,
                                   w, cuda)
    x = x.bfloat16()
    plan = kernels.stem_plan("bfloat16", b, h, w, tuple(
        t.data_ptr() for t in (x, *(p.bfloat16() for p in params
                                    if p.dim() == 4))), kernels.sm_count(cuda))
    assert plan["p1"]["vec"] == int(w % 8 == 0)
    counts = [f.launches for f in (ST.stem_fused_inference, ST.stem_fused,
                                   ST.stem_fused_backward)]
    _stem_bf16_all_modes(x, params, cuda, 0.25)
    assert [f.launches for f in (ST.stem_fused_inference, ST.stem_fused,
                                 ST.stem_fused_backward)] == [
        counts[0] + 1, counts[1] + 2, counts[2] + 2]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 20, 44), (3, 12, 28), (2, 44, 20)])
def test_stem_bf16_odd_shapes_against_float64(cuda, shape):
    """A witness of K4-b at the odd shapes whose bound bf16 noise does not
    set: K4-b's ten gradients and the plain bf16 chain's against the plain
    chain in float64 on the same bf16-rounded inputs (x in bf16, the conv
    kernels rounded to bf16 as both bf16 routes compute with; the chain's
    f32 casts widened to float64). Each of the kernel's errors is at most
    2x the plain bf16 chain's (each error x max|float64|)."""
    b, h, w = shape
    x, params = _stem_train_inputs(torch.Generator().manual_seed(15), b, h,
                                   w, cuda)
    x = x.bfloat16()
    ps = [p.clone().requires_grad_() for p in params]
    rs = [p.clone().requires_grad_() for p in params]
    y3, ms, vs = ST.stem_fused(x, *ps)
    _stem_loss((y3, ms, vs)).backward()
    with torch.backends.cudnn.flags(allow_tf32=False):
        _stem_loss(ST.stem_train_reference(x, *rs)).backward()
        ds = [(p.bfloat16() if p.dim() == 4 else p).double().requires_grad_()
              for p in params]
        real_float = torch.Tensor.float
        torch.Tensor.float = lambda t, *a, **k: t.double()
        try:
            _stem_loss(ST.stem_train_reference(x.double(), *ds)).backward()
        finally:
            torch.Tensor.float = real_float
    for p, r, d in zip(ps, rs, ds):
        scale = d.grad.abs().max()
        ek = ((p.grad.double() - d.grad).abs().max() / scale).item()
        ep = ((r.grad.double() - d.grad).abs().max() / scale).item()
        assert ek <= 2 * ep, (ek, ep)


@pytest.mark.gpu
def test_stem_misaligned_x_stages_by_element(cuda):
    """A contiguous bf16 x whose data pointer breaks 16-byte alignment
    takes element staging in stem1 and dk1 (the plans say so) and still
    agrees with the plain stem: eval, train forward and K4-b."""
    from robust_object_detection_tpu_torch import kernels
    b, h, w = 2, 128, 128
    x, params = _stem_train_inputs(torch.Generator().manual_seed(16), b, h,
                                   w, cuda)
    x = _misaligned(x.bfloat16())
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    kb = [p.bfloat16() for p in params if p.dim() == 4]
    sm = kernels.sm_count(cuda)
    fw = kernels.stem_plan("bfloat16", b, h, w,
                           tuple(t.data_ptr() for t in (x, *kb)), sm)
    assert [fw[k]["vec"] for k in ("p1", "c2a", "c2b", "p3")] == [0, 1, 1, 1]
    dy3 = torch.zeros(b, h // 4, w // 4, 32, dtype=torch.bfloat16,
                      device=cuda)
    bw = kernels.stem_bwd_plan("bfloat16", b, h, w, tuple(
        t.data_ptr() for t in (x, kb[1], kb[2], kb[3], dy3)), sm)
    assert (bw["vec"], bw["vec_x"]) == (1, 0)
    _stem_bf16_all_modes(x, params, cuda, 8e-2)


def _stem64(x, params, train=True, running=None):
    """The stem in float64 (flax's fast variance in train mode; BN1, BN2a,
    BN2b from `running` (means, variances) in eval mode), differentiable:
    y3 (NHWC) and, in train mode, the four means and four variances."""
    F = torch.nn.functional
    k1, sc1, bi1, k2a, sc2a, bi2a, k2b, sc2b, bi2b, k3 = (
        t.double() for t in params)

    def conv(a, k, stride, pad):
        return F.conv2d(a, k.permute(3, 2, 0, 1), stride=stride,
                        padding=pad)

    def stats(y):
        m = y.mean((0, 2, 3))
        return m, torch.clamp((y * y).mean((0, 2, 3)) - m * m, min=0.0)
    ms, vs = [], []

    def bn_relu(y, sc, bi, i):
        m, v = stats(y) if train else (running[0][i].double(),
                                       running[1][i].double())
        ms.append(m)
        vs.append(v)
        g = sc * torch.rsqrt(v + 1e-3)
        return torch.relu(y * g[:, None, None] + (bi - m * g)[:, None, None])
    a1 = bn_relu(conv(x.double().permute(0, 3, 1, 2), k1, 2, 1), sc1, bi1, 0)
    a2a = bn_relu(conv(F.pad(a1, (0, 1, 0, 1)), k2a, 1, 0), sc2a, bi2a, 1)
    a2b = bn_relu(conv(F.pad(a2a, (0, 1, 0, 1)), k2b, 1, 0), sc2b, bi2b, 2)
    y3 = conv(torch.cat([ST._pool2x2(a1), a2b], 1), k3, 2, 1)
    if not train:
        return y3.permute(0, 2, 3, 1)
    m3, v3 = stats(y3)
    return y3.permute(0, 2, 3, 1), (*ms, m3), (*vs, v3)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 20, 44), (3, 12, 28), (2, 44, 20),
                                   (2, 36, 52)])
def test_stem_f32_matches_float64(cuda, shape):
    """K4's f32 route (split TF32) against the stem in float64 at odd
    shapes (H != W, H/4 and W/4 odd, ragged tiles, small B): eval and
    train y3 and the eight statistics within 1e-5 x max|ref|, K4-b's ten
    gradients for the loss's cotangents within chip_smoke.K4B_TOL's
    1.5e-4 (one pass of TF32 puts the 2x2 filter gradients several percent
    off at these sizes: tests/test_torch_stem_tf32.py); K4-f train and K4-b
    the same bits twice."""
    b, h, w = shape
    g = torch.Generator().manual_seed(17)
    x, params = _stem_train_inputs(g, b, h, w, cuda)
    sizes = (32, 16, 32)
    running = ([_rand(g, c, scale=0.1).to(cuda) for c in sizes],
               [(torch.rand(c, generator=g) + 0.5).to(cuda) for c in sizes])
    ev = [x, *params, *running]
    out = ST.stem_fused_inference(*ev)
    assert out.dtype == torch.float32
    assert _rel_err(out.double(), _stem64(x, params, False, running)) <= 1e-5
    runs = []
    for _ in range(2):
        ps = [p.clone().requires_grad_() for p in params]
        y3, ms, vs = ST.stem_fused(x, *ps)
        _stem_loss((y3, ms, vs)).backward()
        runs.append([y3.detach(), *ms, *vs] + [p.grad for p in ps])
    assert all(torch.equal(a, r) for a, r in zip(*runs))
    ds = [p.double().requires_grad_() for p in params]
    ry3, rms, rvs = _stem64(x, ds)
    _stem_loss((ry3, rms, rvs)).backward()
    for i, (o, r) in enumerate(zip(runs[0][:9], (ry3, *rms, *rvs))):
        assert _rel_err(o.double(), r.detach()) <= 1e-5, i
    for i, (o, d) in enumerate(zip(runs[0][9:], ds)):
        assert _rel_err(o.double(), d.grad) <= 1.5e-4, i


@pytest.mark.gpu
def test_stem_f32_misaligned_x_stages_by_element(cuda):
    """An f32 x one element past a 16-byte line takes element staging in
    stem1 and dk1 (the plans say so) and the f32 stem still holds float64:
    eval, train forward and K4-b."""
    from robust_object_detection_tpu_torch import kernels
    b, h, w = 2, 36, 52
    g = torch.Generator().manual_seed(18)
    x, params = _stem_train_inputs(g, b, h, w, cuda)
    x = _misaligned(x)
    sm = kernels.sm_count(cuda)
    kf = [p for p in params if p.dim() == 4]
    fw = kernels.stem_plan("float32", b, h, w,
                           tuple(t.data_ptr() for t in (x, *kf)), sm)
    assert [fw[k]["vec"] for k in ("p1", "c2a", "c2b", "p3")] == [0, 1, 1, 1]
    dy3 = torch.zeros(b, h // 4, w // 4, 32, device=cuda)
    bw = kernels.stem_bwd_plan("float32", b, h, w, tuple(
        t.data_ptr() for t in (x, kf[1], kf[2], kf[3], dy3)), sm)
    assert (bw["vec"], bw["vec_x"]) == (1, 0)
    sizes = (32, 16, 32)
    running = ([torch.zeros(c, device=cuda) for c in sizes],
               [torch.ones(c, device=cuda) for c in sizes])
    out = ST.stem_fused_inference(x, *params, *running)
    assert _rel_err(out.double(), _stem64(x, params, False, running)) <= 1e-5
    ps = [p.clone().requires_grad_() for p in params]
    y3, ms, vs = ST.stem_fused(x, *ps)
    _stem_loss((y3, ms, vs)).backward()
    ds = [p.double().requires_grad_() for p in params]
    ry3, rms, rvs = _stem64(x, ds)
    _stem_loss((ry3, rms, rvs)).backward()
    assert _rel_err(y3.double(), ry3.detach()) <= 1e-5
    for i, (p, d) in enumerate(zip(ps, ds)):
        assert _rel_err(p.grad.double(), d.grad) <= 1.5e-4, i


@pytest.mark.gpu
@pytest.mark.parametrize("bad", [math.inf, -math.inf])
def test_stem_f32_non_finite_input_gives_float64_pattern(cuda, bad):
    """An Inf or -Inf in x gives +Inf outputs of f32 K4-f (eval) exactly
    where the float64 stem has them, and finite values elsewhere: the
    split's guard (hi = 0, lo = the value) keeps Inf x (a TF32 weight's lo,
    0) from turning into NaN. stem2a, stem2b and stem3 take non-negative
    filters, one of them of TF32 values (lo = 0), so that no sum meets Inf
    - Inf: a NaN would meet ReLU, which is fmaxf in the kernels (NaN -> 0)
    and torch.relu in float64 (NaN)."""
    g = torch.Generator().manual_seed(19)
    b, h, w = 1, 20, 44
    x, params = _stem_train_inputs(g, b, h, w, cuda)
    params = [p.abs() if p.dim() == 4 and i > 0 else p
              for i, p in enumerate(params)]
    params[9] = (params[9].view(torch.int32) & -8192).view(torch.float32)
    x = x.clone()
    x[0, 9, 21, 1] = bad
    sizes = (32, 16, 32)
    running = ([torch.zeros(c, device=cuda) for c in sizes],
               [torch.ones(c, device=cuda) for c in sizes])
    out = ST.stem_fused_inference(x, *params, *running)
    ref = _stem64(x, params, False, running)
    assert int(torch.isposinf(ref).sum()) > 0
    for test in (torch.isnan, torch.isposinf, torch.isneginf):
        assert torch.equal(test(out), test(ref)), test.__name__
    fin = torch.isfinite(ref)
    assert _rel_err(out[fin].double(), ref[fin]) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", [
    (((128, 128), (64, 64), (32, 32)), 2, 428, 8, 32, 4),
    (((6, 10), (3, 5)), 1, 7, 3, 32, 2),
    (((5, 7), (3, 3), (2, 1), (1, 1)), 2, 13, 2, 8, 8),
    (((9, 4),), 1, 5, 1, 48, 3)])
def test_deform_backward_matches_plain(cuda, dtype, tol, case):
    """K5 backward against the autograd of the plain gather version in f32
    on the same values: d(values) (one rounding of an f32 sum in tap
    order), d(loc) and d(attn) within tol x max|ref|; a second run gives
    the same bits, d(values) is K5-g2's backward's on the same inputs, and
    d(loc) and d(attn) keep their bits under a permutation of the
    queries."""
    shapes, b, q, heads, dh, p = case
    values, shapes, loc, attn = _deform_inputs(
        torch.Generator().manual_seed(11), shapes, b, q, heads, dh, p, cuda,
        dtype)
    dout = _rand(torch.Generator().manual_seed(12), b, q, heads, dh).to(
        cuda, dtype)
    leaves = [t.clone().requires_grad_() for t in (values, loc, attn)]
    before = DF.ms_deform_attn_backward.launches
    DF.ms_deform_attn_slots(leaves[0], shapes, leaves[1],
                            leaves[2]).backward(dout)
    torch.cuda.synchronize()
    assert DF.ms_deform_attn_backward.launches == before + 1
    assert leaves[0].grad.dtype == dtype
    refs = [t.float().clone().requires_grad_() for t in (values, loc, attn)]
    DF.ms_deform_attn_ref(refs[0], shapes, refs[1], refs[2]).backward(
        dout.float())
    for name, l, r in zip(("values", "loc", "attn"), leaves, refs):
        assert _rel_err(l.grad, r.grad) <= tol, name
    again = DF.ms_deform_attn_backward(values, shapes, loc, attn, dout)
    for a, l in zip(again, leaves):
        assert torch.equal(a, l.grad)
    assert torch.equal(DF.ms_deform_attn_sorted_backward(
        values, shapes, loc, attn, dout.float())[0], leaves[0].grad)
    perm = torch.randperm(q, generator=torch.Generator().manual_seed(0)).to(
        cuda)
    _, dloc, dattn = DF.ms_deform_attn_backward(
        values, shapes, loc[:, perm].contiguous(), attn[:, perm].contiguous(),
        dout[:, perm].contiguous())
    assert torch.equal(dloc, leaves[1].grad[:, perm])
    assert torch.equal(dattn, leaves[2].grad[:, perm])


def _auction_case(name):
    g = torch.Generator().manual_seed(13)
    if name == "normal":        # distinct costs: the auction converges
        b, q, m, n_valid = 4, 300, 300, 80
        cost = torch.rand(b, q, m, generator=g) * 4
    elif name == "odd":
        b, q, m, n_valid = 3, 7, 5, 3
        cost = torch.rand(b, q, m, generator=g) * 4
    elif name == "capped":      # as many GTs as queries: the last few
        b, q, m, n_valid = 8, 300, 300, 300     # fight past the round cap
        cost = torch.rand(b, q, m, generator=g) * 4
    elif name == "ties":        # costs on a 1/64 grid, converging and not
        b, q, m, n_valid = 4, 300, 300, 300
        cost = torch.round(torch.rand(b, q, m, generator=g) * 256) / 64
    elif name == "cheap_invalid":   # an invalid column priced below BIG / 2
        b, q, m, n_valid = 3, 40, 30, 30
        cost = torch.rand(b, q, m, generator=g) * 4
    elif name == "alike":       # every GT ranks the queries alike: caps
        b, q, m, n_valid = 4, 300, 300, 80
        cost = torch.rand(b, q, 1, generator=g) * 4 \
            + 0.05 * torch.rand(b, q, m, generator=g)
    elif name == "past_capacity":   # more GT rows than shared memory holds
        b, q, m, n_valid = 2, 300, 420, 420
        cost = torch.rand(b, q, m, generator=g) * 4
    else:                       # more valid GTs than queries
        b, q, m, n_valid = 2, 6, 9, 9
        cost = torch.rand(b, q, m, generator=g)
    valid = torch.zeros(b, m, dtype=torch.bool)
    valid[:, :n_valid] = True
    valid[0] = False            # an image with no valid GT
    cost = torch.where(valid[:, None, :], cost, torch.full_like(cost, AS.BIG))
    if name == "cheap_invalid":
        cost[:, :, m - 1] = 2.5
        valid[:, m - 1] = False
    return cost, valid


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["normal", "odd", "capped", "crowded",
                                  "ties", "cheap_invalid", "alike",
                                  "past_capacity"])
@pytest.mark.parametrize("max_rounds", [16, 150])
def test_auction_kernel_equals_plain(cuda, name, max_rounds):
    """K6 against the plain round loop + greedy completion on the same
    costs: the same assignment and the same capped flags, by equality."""
    cost, valid = _auction_case(name)
    before = AS.auction_assignment.launches
    owner, capped = AS.auction_assignment(cost.to(cuda), valid.to(cuda),
                                          max_rounds=max_rounds)
    torch.cuda.synchronize()
    assert AS.auction_assignment.launches == before + 1
    ref_owner, ref_capped = AS.auction_assignment(cost, valid,
                                                  max_rounds=max_rounds)
    assert owner.dtype == torch.int32 and capped.dtype == torch.bool
    assert torch.equal(capped.cpu(), ref_capped)
    assert torch.equal(owner.cpu(), ref_owner)
    if name == "capped" and max_rounds == 16:
        assert bool(ref_capped[1:].all())       # the greedy branch ran
    raw, _ = AS.auction_assignment(cost.to(cuda), valid.to(cuda),
                                   max_rounds=max_rounds,
                                   complete_greedy=False)
    ref_raw, _ = AS.auction_assignment_ref(cost, valid, 0.005, max_rounds)
    assert torch.equal(raw.cpu(), ref_raw)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["normal", "capped"])
def test_auction_rounds_are_counted_in_one_launch(cuda, name):
    """``auction_assignment_rounds`` is K6's launch with its round counts:
    the same owner and capped, one launch, 16 auction rounds and some
    greedy rounds in a capped image, none in a converged one."""
    cost, valid = _auction_case(name)
    cost, valid = cost.to(cuda), valid.to(cuda)
    owner, capped = AS.auction_assignment(cost, valid, max_rounds=16)
    before = AS.auction_assignment.launches
    owner2, capped2, rounds = AS.auction_assignment_rounds(cost, valid,
                                                           max_rounds=16)
    assert AS.auction_assignment.launches == before + 1
    assert torch.equal(owner, owner2) and torch.equal(capped, capped2)
    assert rounds.shape == (cost.shape[0], 2) and rounds.dtype == torch.int32
    for (auction, greedy), cap in zip(rounds.tolist(), capped.tolist()):
        assert (auction == 16 and greedy > 0) if cap else greedy == 0


@pytest.mark.gpu
def test_rtdetr_train_kernels_raise_on_cuda_tensors_they_do_not_take(cuda):
    x, params = _stem_train_inputs(torch.Generator().manual_seed(14), 1, 8,
                                   8, cuda)
    before = (ST.stem_fused.launches, AS.auction_assignment.launches)
    with pytest.raises(ValueError, match="multiples of 4"):
        ST.stem_fused(x[:, :6], *params)
    with pytest.raises(ValueError, match="dtype"):
        ST.stem_fused(x.half(), *params)
    with pytest.raises(ValueError, match="device"):
        ST.stem_fused(x, params[0].cpu(), *params[1:])
    cost = torch.zeros(1, 4, 3, device=cuda)
    valid = torch.ones(1, 3, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="float32 cost"):
        AS.auction_assignment(cost.double(), valid)
    with pytest.raises(ValueError, match="does not match"):
        AS.auction_assignment(cost, valid[:, :2])
    with pytest.raises(ValueError, match="one device"):
        AS.auction_assignment(cost, valid.cpu())
    assert (ST.stem_fused.launches, AS.auction_assignment.launches) == before


SORTED_CASES = [
    (((128, 128), (64, 64), (32, 32)), 2, 428, 8, 32, 4),
    (((6, 10), (3, 5)), 1, 7, 3, 32, 2),
    (((5, 7), (3, 3), (2, 1), (1, 1)), 2, 13, 2, 8, 8),
    (((9, 4),), 1, 5, 1, 48, 3),
    (((40, 40), (20, 20)), 1, 50, 2, 40, 4),
    (((1024, 1024),), 1, 200, 1, 4, 4)]       # 2^20 cells


def _sorted_entry(transposed):
    return DF.ms_deform_attn_t if transposed else DF.ms_deform_attn


@pytest.mark.gpu
@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-5)])
@pytest.mark.parametrize("case", SORTED_CASES)
def test_sorted_deform_forward_matches_plain(cuda, dtype, tol, case,
                                             transposed):
    """K5-g2 forward in both layouts against the plain gather version in
    f32 on the same values: f32 out from f32 or bf16 values, so both are
    the same f32 products in another summation order."""
    shapes, b, q, heads, dh, p = case
    values, shapes, loc, attn = _deform_inputs(
        torch.Generator().manual_seed(15), shapes, b, q, heads, dh, p, cuda,
        dtype)
    given = DF.values_to_t(values) if transposed else values
    before = DF.ms_deform_attn_sorted_forward.launches
    out = _sorted_entry(transposed)(given, shapes, loc, attn)
    torch.cuda.synchronize()
    assert DF.ms_deform_attn_sorted_forward.launches == before + 1
    assert out.shape == (b, q, heads, dh) and out.dtype == torch.float32
    ref = DF.ms_deform_attn_ref(values.float(), shapes, loc, attn)
    assert _rel_err(out, ref) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SORTED_CASES)
def test_sorted_deform_forward_is_k5_gather_bit_for_bit(cuda, dtype, case):
    """K5-g2 forward runs K5's gather with an f32 out: on `values` in f32
    it equals K5 forward bit for bit, and in bf16 its out rounded once to
    bf16 equals K5's; values_t (relaid into rows, then gathered) equals
    `values`; a permutation of the queries permutes the out bit for bit."""
    shapes, b, q, heads, dh, p = case
    g = torch.Generator().manual_seed(22)
    values, shapes, loc, attn = _deform_inputs(g, shapes, b, q, heads, dh,
                                               p, cuda, dtype)
    out = DF.ms_deform_attn(values, shapes, loc, attn)
    k5 = DF.ms_deform_attn_slots(values, shapes, loc, attn)
    assert out.dtype == torch.float32 and k5.dtype == dtype
    assert torch.equal(out.to(dtype), k5)
    assert torch.equal(DF.ms_deform_attn_t(DF.values_to_t(values), shapes,
                                           loc, attn), out)
    perm = torch.randperm(q, generator=g).to(cuda)
    assert torch.equal(DF.ms_deform_attn(values, shapes,
                                         loc[:, perm].contiguous(),
                                         attn[:, perm].contiguous()),
                       out[:, perm])


@pytest.mark.gpu
@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [SORTED_CASES[1], SORTED_CASES[2],
                                  SORTED_CASES[3]])
def test_sorted_deform_forward_misaligned_values(cuda, dtype, case,
                                                 transposed):
    """values (element loads in the gather) or values_t (element loads in
    the relayout, 16-byte pieces in the gather of the aligned workspace)
    one element past a 16-byte boundary, at the odd shapes: the plain
    version's f32 sum within 1e-4 x max|ref|."""
    shapes, b, q, heads, dh, p = case
    values, shapes, loc, attn = _deform_inputs(
        torch.Generator().manual_seed(23), shapes, b, q, heads, dh, p, cuda,
        dtype)
    given = _misaligned(DF.values_to_t(values) if transposed else values)
    assert given.data_ptr() % 16 != 0
    out = _sorted_entry(transposed)(given, shapes, loc, attn)
    ref = DF.ms_deform_attn_ref(values.float(), shapes, loc, attn)
    assert _rel_err(out, ref) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("case", SORTED_CASES)
def test_sorted_deform_backward_matches_plain(cuda, dtype, tol, case,
                                              transposed):
    """K5-g2 backward in both layouts against the plain backward in f32 on
    the same values (d(values): one rounding to values' dtype; d(loc),
    d(attn) f32 sums in another order, 1e-4 / 1e-3), taps outside the maps
    included; a second run returns the same bits in all three."""
    shapes, b, q, heads, dh, p = case
    values, shapes, loc, attn = _deform_inputs(
        torch.Generator().manual_seed(16), shapes, b, q, heads, dh, p, cuda,
        dtype, lo=-0.4, hi=1.4)
    dout = _rand(torch.Generator().manual_seed(17), b, q, heads, dh).to(cuda)
    given = DF.values_to_t(values) if transposed else values
    leaves = [t.clone().requires_grad_() for t in (given, loc, attn)]
    before = DF.ms_deform_attn_sorted_backward.launches
    _sorted_entry(transposed)(leaves[0], shapes, leaves[1],
                              leaves[2]).backward(dout)
    torch.cuda.synchronize()
    assert DF.ms_deform_attn_sorted_backward.launches == before + 1
    assert leaves[0].grad.dtype == dtype
    assert leaves[0].grad.shape == given.shape
    rdv, rdloc, rdattn = DF.ms_deform_attn_backward_ref(
        values.float(), shapes, loc, attn, dout)
    dv = leaves[0].grad
    dv = DF.values_from_t(dv) if transposed else dv
    ltol = 1e-4 if dtype == torch.float32 else 1e-3
    assert _rel_err(dv, rdv) <= tol
    assert _rel_err(leaves[1].grad, rdloc) <= ltol
    assert _rel_err(leaves[2].grad, rdattn) <= ltol
    again = DF.ms_deform_attn_sorted_backward(given, shapes, loc, attn, dout,
                                              transposed)
    for a, l in zip(again, leaves):
        assert torch.equal(a, l.grad)


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    (8, 8, 32, 6848, 16384), (2, 3, 32, 56, 60), (1, 2, 8, 37, 1),
    (2, 1, 48, 300, 1000), (1, 1, 5, 1, 129),
    (1, 1, 2, 5000, 1 << 20)])                # 2**20 cells
def test_stamp_scatter_matches_plain(cuda, case):
    """K5-g1 against ``index_add_`` (the same f32 terms, perhaps in another
    order: 1e-5 x max|ref|), cells without taps zero, the same bits on a
    second run; taps piled on few cells in the second half of the rows."""
    b, heads, dh, t, hw = case
    g = torch.Generator().manual_seed(18)
    idx = torch.randint(0, hw, (b, heads, t), generator=g, dtype=torch.int32)
    idx[b // 2:] = idx[b // 2:] % max(1, hw // 50)
    idx, gw = idx.to(cuda), _rand(g, b, heads, dh, t).to(cuda)
    before = DF.stamp_scatter.launches
    out = DF.stamp_scatter(idx, gw, hw)
    torch.cuda.synchronize()
    assert DF.stamp_scatter.launches == before + 1
    assert out.shape == (b, heads, dh, hw) and out.dtype == torch.float32
    ref = DF.stamp_scatter_ref(idx, gw, hw)
    assert _rel_err(out, ref) <= 1e-5
    assert torch.equal(out == 0, ref == 0)
    assert torch.equal(DF.stamp_scatter(idx, gw, hw), out)
    assert torch.equal(DF.stamp_scatter(idx.long(), gw, hw), out)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("case", [(2, 128, 128, 8, 32, 300, 4),
                                  (2, 6, 5, 3, 4, 7, 2),
                                  (1, 3, 70, 2, 40, 9, 3)])
def test_bilinear_sample_gradients_match_autograd(cuda, dtype, tol, case):
    """bilinear_sample on the card (d(v) through K5-g1) against the
    autograd of the same gather and weights in f32, samples inside, on the
    edges and outside the map."""
    b, h, w, heads, dh, q, p = case
    g = torch.Generator().manual_seed(19)
    v = _rand(g, b, h, w, heads, dh).to(cuda, dtype)
    sx = (torch.rand(b, q, heads, p, generator=g) * (w + 2.5) - 1.5).to(cuda)
    sy = (torch.rand(b, q, heads, p, generator=g) * (h + 2.5) - 1.5).to(cuda)
    cot = _rand(g, b, q, heads, p, dh).to(cuda)
    leaves = [t.clone().requires_grad_() for t in (v, sx, sy)]
    before = DF.stamp_scatter.launches
    out = DF.bilinear_sample(*leaves)
    out.backward(cot)
    assert DF.stamp_scatter.launches == before + 1
    refs = [t.float().clone().requires_grad_() for t in (v, sx, sy)]
    ref = DF.bilinear_sample_ref(*refs)
    ref.backward(cot)
    assert _rel_err(out, ref.detach()) <= 1e-5
    assert leaves[0].grad.dtype == dtype
    assert _rel_err(leaves[0].grad, refs[0].grad) <= tol
    # d(sx), d(sy): the weights' derivatives jump at integer coordinates,
    # where autograd of floor() and the analytic rule agree (both one-sided)
    assert _rel_err(leaves[1].grad, refs[1].grad) <= 1e-4
    assert _rel_err(leaves[2].grad, refs[2].grad) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("shapes,p", [
    (((8, 8), (4, 4), (2, 2), (2, 1), (1, 1)), 8), (((6, 10), (3, 5)), 17)])
def test_deform_entries_refuse_what_the_kernels_do_not_instantiate(
        cuda, shapes, p):
    """Five levels, or more than 32 points a query and head: the CPU runs
    the plain version (tests/test_torch_deform_shapes.py); on the card
    every entry point raises before any launch, with or without a
    gradient."""
    g = torch.Generator().manual_seed(21)
    values, shapes, loc, attn = _deform_inputs(g, shapes, 1, 3, 2, 8, p, cuda,
                                               torch.float32)
    counters = (DF.ms_deform_attn_slots, DF.ms_deform_attn_backward,
                DF.ms_deform_attn_sorted_forward,
                DF.ms_deform_attn_sorted_backward)
    before = [f.launches for f in counters]
    vg = values.clone().requires_grad_()
    for call in (lambda: DF.ms_deform_attn_slots(values, shapes, loc, attn),
                 lambda: DF.ms_deform_attn_slots(vg, shapes, loc, attn),
                 lambda: DF.ms_deform_attn(vg, shapes, loc, attn),
                 lambda: DF.ms_deform_attn_t(DF.values_to_t(values), shapes,
                                             loc, attn),
                 lambda: DF.ms_deform_attn_backward(values, shapes, loc,
                                                    attn, values[:, :3])):
        with pytest.raises(ValueError, match="at most 4 levels and 32"):
            call()
    torch.cuda.synchronize()
    assert [f.launches for f in counters] == before


@pytest.mark.gpu
def test_sorted_deform_kernels_raise_on_cuda_tensors_they_do_not_take(cuda):
    g = torch.Generator().manual_seed(20)
    values, shapes, loc, attn = _deform_inputs(
        g, ((4, 4), (2, 2)), 1, 3, 2, 8, 2, cuda, torch.float32)
    idx = torch.zeros(1, 2, 5, dtype=torch.int32, device=cuda)
    gw = torch.zeros(1, 2, 8, 5, device=cuda)
    counters = (DF.ms_deform_attn_sorted_forward,
                DF.ms_deform_attn_sorted_backward, DF.stamp_scatter)
    before = [f.launches for f in counters]
    with pytest.raises(ValueError, match="float32 loc"):
        DF.ms_deform_attn(values.half(), shapes, loc, attn)
    with pytest.raises(ValueError, match="do not match"):
        DF.ms_deform_attn_t(values, shapes, loc, attn)   # the other layout
    with pytest.raises(ValueError, match="contiguous"):
        DF.ms_deform_attn_t(values.permute(0, 2, 3, 1), shapes, loc, attn)
    with pytest.raises(ValueError, match="takes dout"):
        DF.ms_deform_attn_sorted_backward(values, shapes, loc, attn,
                                          values[:, :2])
    with pytest.raises(ValueError, match="CUDA card"):
        DF.ms_deform_attn_sorted_forward(values.cpu(), shapes, loc.cpu(),
                                         attn.cpu())
    with pytest.raises(ValueError, match="float32 gw"):
        DF.stamp_scatter(idx, gw.double(), 16)
    with pytest.raises(ValueError, match="idx \\(B,heads,T\\)"):
        DF.stamp_scatter(idx[:, :, :4], gw, 16)
    with pytest.raises(ValueError, match="one cpu or cuda device"):
        DF.stamp_scatter(idx.cpu(), gw, 16)
    with pytest.raises(ValueError, match="float32 sx"):
        DF.bilinear_sample(values.reshape(1, 4, 5, 2, 8),
                           loc[..., 0, :, 0].double(), loc[..., 0, :, 1])
    assert [f.launches for f in counters] == before


# ---- K5-g1 and K5 forward as redesigned for Hopper --------------------------


def _stamp_in_t_order(idx, gw, hw):
    """dv summed tap by tap in the order of t from +0.0, on the card: the
    sequence of fadds K5-g1 makes for every cell (each step adds one tap of
    every row; no two land on one element)."""
    b, heads, dh, t = gw.shape
    rows = torch.arange(b * heads, device=gw.device)
    dv = torch.zeros(b * heads, dh, hw, device=gw.device)
    flat_idx = idx.reshape(b * heads, t).long()
    flat_gw = gw.reshape(b * heads, dh, t)
    for k in range(t):
        dv[rows, :, flat_idx[:, k]] += flat_gw[:, :, k]
    return dv.reshape(b, heads, dh, hw)


def _rows_layout(gw):
    """gw (B, heads, dh, T) as the transpose of a contiguous (B, heads, T,
    dh): channel stride 1."""
    return gw.transpose(2, 3).contiguous().transpose(2, 3)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["reference", "rows"])
@pytest.mark.parametrize("case", [
    (8, 8, 32, 6848, 16384), (8, 8, 32, 6848, 4096), (8, 8, 32, 6848, 1024),
    (2, 3, 32, 37, 1000), (1, 2, 40, 300, 129), (2, 1, 5, 33, 7),
    (1, 1, 2, 5000, 1 << 20)])
def test_stamp_scatter_layouts_match_plain(cuda, layout, case):
    """K5-g1 in either gw layout: within 1e-5 x max|ref| of ``index_add_``,
    one launch, the same bits on a second run, from the other layout and
    from int64 idx. The RT-DETR-L levels, and hw that is no multiple of the
    tile or of 4, T no multiple of 32, dh over 32 channels, a map of 2**20
    cells."""
    b, heads, dh, t, hw = case
    g = torch.Generator().manual_seed(21)
    idx = torch.randint(0, hw, (b, heads, t), generator=g,
                        dtype=torch.int32).to(cuda)
    gw = _rand(g, b, heads, dh, t).to(cuda)
    given, other = (gw, _rows_layout(gw)) if layout == "reference" \
        else (_rows_layout(gw), gw)
    before = DF.stamp_scatter.launches
    out = DF.stamp_scatter(idx, given, hw)
    torch.cuda.synchronize()
    assert DF.stamp_scatter.launches == before + 1
    assert out.shape == (b, heads, dh, hw) and out.dtype == torch.float32
    assert _rel_err(out, DF.stamp_scatter_ref(idx, gw, hw)) <= 1e-5
    assert torch.equal(DF.stamp_scatter(idx, given, hw), out)
    assert torch.equal(DF.stamp_scatter(idx, other, hw), out)
    assert torch.equal(DF.stamp_scatter(idx.long(), given, hw), out)


@pytest.mark.gpu
@pytest.mark.parametrize("case", [(2, 3, 32, 300, 1000), (1, 2, 40, 57, 60),
                                  (8, 8, 32, 428, 4096)])
def test_stamp_scatter_sums_in_tap_order(cuda, case):
    """Every cell is the sum of its taps in the order of t from +0.0, bit
    for bit (the order a sort by (cell, t) and a segmented sum give), with
    taps piled on few cells."""
    b, heads, dh, t, hw = case
    g = torch.Generator().manual_seed(22)
    idx = torch.randint(0, hw, (b, heads, t), generator=g, dtype=torch.int32)
    idx[:, 0] = idx[:, 0] % 5
    idx, gw = idx.to(cuda), _rand(g, b, heads, dh, t).to(cuda)
    want = _stamp_in_t_order(idx, gw, hw)
    assert torch.equal(DF.stamp_scatter(idx, gw, hw), want)
    assert torch.equal(DF.stamp_scatter(idx, _rows_layout(gw), hw), want)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["reference", "rows"])
def test_stamp_scatter_one_cell_and_empty_tiles(cuda, layout):
    """A row whose 6848 taps all land on one cell (one warp adds them all,
    across several refills of the block's tap list), a row whose taps
    cover only the first cells (the other tiles find none and store
    zeros), and cells that get no tap at all."""
    b, heads, dh, t, hw = 2, 2, 32, 6848, 16384
    g = torch.Generator().manual_seed(23)
    idx = torch.randint(0, 64, (b, heads, t), generator=g, dtype=torch.int32)
    idx[0, 0] = hw - 1
    idx[1, 1] = 777
    idx, gw = idx.to(cuda), _rand(g, b, heads, dh, t).to(cuda)
    given = gw if layout == "reference" else _rows_layout(gw)
    out = DF.stamp_scatter(idx, given, hw)
    ref = DF.stamp_scatter_ref(idx, gw, hw)
    assert _rel_err(out, ref) <= 1e-5
    assert torch.equal(out == 0, ref == 0)
    assert torch.equal(out[0, 0, :, :hw - 1], torch.zeros_like(
        out[0, 0, :, :hw - 1]))
    assert torch.equal(out[0, 0, :, hw - 1], _stamp_in_t_order(
        idx[:1, :1], gw[:1, :1], hw)[0, 0, :, hw - 1])
    assert torch.equal(out[:, :, :, 64:].count_nonzero(),
                       out[0, 0, :, hw - 1].count_nonzero()
                       + out[1, 1, :, 777].count_nonzero())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("case,fixed", [
    ((((128, 128), (64, 64), (32, 32)), 2, 1, 8, 32, 4), 1),    # Q 1
    ((((6, 10), (3, 5), (2, 2)), 1, 7, 3, 32, 4), 1),           # odd maps
    ((((5, 7), (3, 3)), 2, 9, 2, 24, 2), 0),                    # dh 24
    ((((4, 6), (3, 3), (2, 2), (1, 2)), 1, 5, 2, 16, 8), 0),    # L P 32
    ((((9, 4),), 1, 3, 1, 200, 1), 0)])                         # 2 passes
def test_deform_forward_instantiations(cuda, dtype, tol, case, fixed):
    """K5 forward's (3, 4) x 32-channel instantiation and the generic one
    (any L, P, dh; several channel passes) against the plain version, one
    launch, the same bits with grad and without, and for any query
    order."""
    from robust_object_detection_tpu_torch import kernels
    shapes, b, q, heads, dh, p = case
    values, shapes, loc, attn = _deform_inputs(
        torch.Generator().manual_seed(24), shapes, b, q, heads, dh, p, cuda,
        dtype)
    plan = kernels.deform_fwd_plan(len(shapes), p, dh,
                                   values.element_size(), values.data_ptr())
    assert plan["fixed"] == fixed and plan["vec"] == 16 // \
        values.element_size()
    before = DF.ms_deform_attn_slots.launches
    out = DF.ms_deform_attn_slots(values, shapes, loc, attn)
    torch.cuda.synchronize()
    assert DF.ms_deform_attn_slots.launches == before + 1
    ref = DF.ms_deform_attn_ref(values.float(), shapes, loc, attn)
    assert out.dtype == dtype and _rel_err(out, ref) <= tol
    leaves = [t.clone().requires_grad_() for t in (values, loc, attn)]
    assert torch.equal(DF.ms_deform_attn_slots(leaves[0], shapes, leaves[1],
                                               leaves[2]).detach(), out)
    perm = torch.randperm(q, generator=torch.Generator().manual_seed(1))
    outp = DF.ms_deform_attn_slots(values, shapes, loc[:, perm].contiguous(),
                                   attn[:, perm].contiguous())
    assert torch.equal(outp, out[:, perm])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_deform_forward_edges(cuda, dtype, tol):
    """Every tap outside its map gives an exact 0; values and loc one
    element past a 16-byte boundary (element loads of values, the generic
    instantiation) match the plain version."""
    shapes = ((128, 128), (64, 64), (32, 32))
    g = torch.Generator().manual_seed(25)
    values, shapes, loc, attn = _deform_inputs(g, shapes, 2, 37, 8, 32, 4,
                                               cuda, dtype, lo=1.6, hi=2.5)
    out = DF.ms_deform_attn_slots(values, shapes, loc, attn)
    assert torch.equal(out, torch.zeros_like(out))
    values, shapes, loc, attn = _deform_inputs(g, shapes, 2, 37, 8, 32, 4,
                                               cuda, dtype)
    mv, ml = _misaligned(values), _misaligned(loc)
    from robust_object_detection_tpu_torch import kernels
    assert kernels.deform_fwd_plan(3, 4, 32, mv.element_size(),
                                   mv.data_ptr())["vec"] == 1
    ref = DF.ms_deform_attn_ref(values.float(), shapes, loc, attn)
    out = DF.ms_deform_attn_slots(mv, shapes, ml, attn)
    assert _rel_err(out, ref) <= tol
    assert torch.equal(DF.ms_deform_attn_slots(values, shapes, ml, attn),
                       DF.ms_deform_attn_slots(values, shapes, loc, attn))


# ── the restored stream: U-Net, SSIM, the 8-pass step ────────────────────

def _unet_pair(cuda, channels=(8, 16, 32, 64), train=False):
    """The same seeded U-Net on the CPU and on the card, its running
    statistics and biases redrawn so eval BatchNorm is not the identity."""
    from robust_object_detection_tpu_torch.models import unet as U
    cpu = U.create(channels, device="cpu",
                   generator=torch.Generator().manual_seed(0), train=train)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, t in cpu.state_dict().items():
            if name.endswith("running_mean") or name.endswith(".bias"):
                t.copy_(torch.randn(t.shape, generator=g) * 0.1)
            elif name.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=g) * 0.5 + 0.75)
    gpu = U.create(channels, device=cuda, train=train)
    gpu.load_state_dict(cpu.state_dict())
    return cpu, gpu


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 32, 48), (1, 37, 53)])
def test_unet_card_matches_cpu(cuda, shape):
    """f32 forward with cuDNN's TF32 off within 1e-4 (odd sizes through
    restore_image), the u8 apply within 1 LSB."""
    from robust_object_detection_tpu_torch.models import unet as U
    cpu, gpu = _unet_pair(cuda)
    b, h, w = shape
    x = torch.rand(b, h, w, 3, generator=torch.Generator().manual_seed(2))
    with torch.backends.cudnn.flags(allow_tf32=False):
        if b == 1:
            out = U.restore_image(gpu, x[0].to(cuda)).cpu()
            ref = U.restore_image(cpu, x[0])
        else:
            with torch.no_grad():
                out, ref = gpu(x.to(cuda)).cpu(), cpu(x)
        assert out.shape == ref.shape
        assert (out - ref).abs().max().item() <= 1e-4
        xu = U.pad_to_16(torch.randint(0, 256, (2, h, w, 3),
                                       dtype=torch.uint8))[0]
        d = (U.apply_u8(gpu, xu.to(cuda)).cpu().int()
             - U.apply_u8(cpu, xu).int()).abs()
    assert d.max().item() <= 1


@pytest.mark.gpu
def test_ssim_card_ignores_tf32_flags(cuda):
    """SSIM / PSNR / loss on the card equal the CPU's under the process's
    flags with TF32 forced on: the window never reaches cuDNN."""
    from robust_object_detection_tpu_torch.ops import ssim as S
    g = torch.Generator().manual_seed(3)
    a = 0.9 + 0.02 * torch.randn(2, 40, 56, 3, generator=g)
    b = a + 0.01 * torch.randn(a.shape, generator=g)
    ref = [f(a, b).item() for f in (S.ssim, S.psnr, S.restoration_loss)]
    with torch.backends.cudnn.flags(allow_tf32=True):
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            out = [f(a.to(cuda), b.to(cuda)).item()
                   for f in (S.ssim, S.psnr, S.restoration_loss)]
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
    for o, r in zip(out, ref):
        assert abs(o - r) <= 1e-6 * max(1.0, abs(r))


@pytest.mark.gpu
def test_unet_train_step_card_matches_cpu(cuda):
    """One f32 train step from the same weights and draws: loss within
    1e-4 relative, every gradient within 1e-3 x max|ref|."""
    from robust_object_detection_tpu_torch.core.config import (
        RestorationConfig)
    from robust_object_detection_tpu_torch.train import restoration as R
    cpu, gpu = _unet_pair(cuda, train=True)
    batch = torch.randint(0, 256, (2, 32, 48, 3),
                          generator=torch.Generator().manual_seed(4),
                          dtype=torch.uint8)
    draws = R.draw_train(batch.shape, torch.Generator().manual_seed(5))
    step = R.make_train_step(CorruptionConfig())
    tx, _ = R.make_optimizer(RestorationConfig(), 10)
    with torch.backends.cudnn.flags(allow_tf32=False):
        ref = step(R.init_state(cpu, tx), batch, draws=draws)
        out = step(R.init_state(gpu, tx), batch.to(cuda),
                   draws={k: v.to(cuda) for k, v in draws.items()})
    assert abs(out["loss"].item() - ref["loss"].item()) <= 1e-4 * abs(
        ref["loss"].item())
    for (name, p), q in zip(gpu.named_parameters(), cpu.parameters()):
        scale = q.grad.abs().max().item()
        assert (p.grad.cpu() - q.grad).abs().max().item() <= 1e-3 * scale, \
            name


@pytest.mark.gpu
def test_eight_pass_step_card_matches_cpu(cuda):
    """The 8-pass fused step (YOLOv8n f32, the U-Net above, host noise) on
    the card with TF32 off against the CPU: the same valid masks, scores
    within 1e-3, and where neighbouring scores are more than 1e-4 apart
    the same classes and boxes within 0.05 px; the launch counts
    of the card's run (K2-f 1 and K3-f one per hand-kernel conv a forward,
    8 forwards)."""
    from robust_object_detection_tpu_torch.eval import fused_sweep as FS
    from robust_object_detection_tpu_torch.models import yolov8 as Y
    from robust_object_detection_tpu_torch.train import detector as D
    g0 = torch.Generator().manual_seed(7)
    ucpu, ugpu = _unet_pair(cuda)
    ycpu = Y.create(6, "n", torch.float32, "cpu",
                    torch.Generator().manual_seed(0))
    # running statistics redrawn and class-head outputs spread (kernels x
    # 4, biases ~N(0, 1)), so most score gaps lie far above f32 noise
    with torch.no_grad():
        for name, t in ycpu.state_dict().items():
            if name.endswith("running_mean") or name.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=g0) * 0.5 + 0.75)
        for seq in ycpu.model[22].cv3:
            seq[2].weight.mul_(4.0)
            seq[2].bias.copy_(torch.randn(seq[2].bias.shape, generator=g0))
    ygpu = Y.create(6, "n", torch.float32, cuda)
    ygpu.load_state_dict(ycpu.state_dict())
    per_forward = sum(1 for m in ygpu.modules()
                      if getattr(m, "hand_kernel", False))
    g = torch.Generator().manual_seed(6)
    clean = torch.randint(0, 256, (2, 34, 50, 3), generator=g,
                          dtype=torch.uint8)
    noise = torch.randn(clean.shape, generator=g) * 15
    predict = D.make_predict_step(64, num_candidates=64, max_det=32)
    with torch.backends.cudnn.flags(allow_tf32=False):
        ref = FS.make_fused_step(predict, ucpu, (34, 50), 64,
                                 host_noise=True)(ycpu, None, clean, noise)
        before = (C.conv3x3.launches, TF.front_inference.launches)
        out = FS.make_fused_step(predict, ugpu, (34, 50), 64,
                                 host_noise=True)(
            ygpu, None, clean.to(cuda), noise.to(cuda))
        torch.cuda.synchronize()
    assert (C.conv3x3.launches - before[0],
            TF.front_inference.launches - before[1]) == (per_forward * 8, 8)
    boxes, scores, classes, valid = (t.cpu() for t in out)
    assert boxes.shape == (8, 2, 32, 4)
    assert torch.equal(valid, ref[3])
    assert (scores - ref[1]).abs().max().item() <= 1e-3
    # where neighbouring scores lie within f32 noise of each other the NMS
    # order may swap them: classes and boxes where the order is certain
    gap = (ref[1][..., 1:] - ref[1][..., :-1]).abs() > 1e-4
    sure = valid.clone()
    sure[..., 1:] &= gap
    sure[..., :-1] &= gap
    assert sure.sum().item() >= 0.5 * valid.sum().item() > 0
    assert torch.equal(classes[sure], ref[2][sure])
    assert (boxes - ref[0]).abs()[sure].max().item() <= 5e-2


# ── Faster R-CNN ─────────────────────────────────────────────────────────

@pytest.mark.gpu
def test_frcnn_card_matches_cpu(cuda):
    """A small Faster R-CNN (blocks (1, 1, 1, 1), 64 proposals) in f32 on
    the card with TF32 off against the CPU, batch 2 at 96x128: the
    pyramid, the RPN maps and the box head on the CPU's proposals within
    1e-4 x max|ref|; the detections' valid counts equal and, where
    neighbouring scores lie more than 1e-4 apart, the same classes and
    boxes within 5e-2 px. BN statistics, scales and biases are redrawn."""
    from robust_object_detection_tpu_torch.models import frcnn as FR
    from robust_object_detection_tpu_torch.train import frcnn as TFR
    cfg = FR.FrcnnConfig(blocks=(1, 1, 1, 1), pre_nms_topk=256,
                         num_proposals=64)
    cpu = FR.create(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, t in cpu.state_dict().items():
            if name.endswith("running_mean") or name.endswith(".bias"):
                t.copy_(torch.randn(t.shape, generator=g) * 0.1)
            elif name.endswith("running_var") or (
                    name.endswith(".weight") and t.dim() == 1):
                t.copy_(torch.rand(t.shape, generator=g) * 0.5 + 0.75)
        cpu.roi_heads.box_predictor.cls_score.weight.mul_(10.0)
    gpu = FR.create(cfg, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    x = torch.randint(0, 256, (2, 96, 128, 3), generator=g,
                      dtype=torch.uint8)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad(), torch.backends.cudnn.flags(allow_tf32=False):
            pyr_c, obj_c, d_c = cpu.extract(x.float() / 255)
            pyr_g, obj_g, d_g = gpu.extract(x.to(cuda).float() / 255)
            props, _ = FR.generate_proposals(obj_c, d_c, (96, 128), cfg)
            head_c = cpu.roi_forward(pyr_c, props)
            head_g = gpu.roi_forward(pyr_g, props.to(cuda))
            ref = TFR.make_predict_step(cpu, (96, 128))(cpu, x)
            out = TFR.make_predict_step(gpu, (96, 128))(gpu, x.to(cuda))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for o, r in [*zip(pyr_g, pyr_c), (obj_g, obj_c), (d_g, d_c),
                 *zip(head_g, head_c)]:
        assert _rel_err(o.cpu(), r) <= 1e-4
    boxes, scores, classes, valid = (t.cpu() for t in out)
    assert torch.equal(valid.sum(1), ref[3].sum(1)) and valid.any()
    gap = (ref[1][..., 1:] - ref[1][..., :-1]).abs() > 1e-4
    sure = valid & ref[3]
    sure[..., 1:] &= gap
    sure[..., :-1] &= gap
    assert sure.sum().item() >= 0.5 * valid.sum().item() > 0
    assert torch.equal(classes[sure], ref[2][sure])
    assert (boxes - ref[0]).abs()[sure].max().item() <= 5e-2


def _frcnn_train_run(model, device, dtype, batch, draws, props, tl=5):
    """chip_smoke.frcnn_train_step (loaded by path: an installed `tests`
    or `chip_smoke` elsewhere must not shadow this checkout's): one train
    step of a copy of `model`, TF32 off, the first run's proposals
    recorded in `props` and replayed in the next."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke.frcnn_train_step(model, device, dtype, batch, draws, props,
                                  tl)


def _frcnn_train_inputs(size=128, slots=8):
    from robust_object_detection_tpu_torch.models import frcnn as FR
    from robust_object_detection_tpu_torch.train import frcnn as TFR
    cfg = FR.FrcnnConfig(blocks=(1, 1, 1, 1), pre_nms_topk=128,
                         num_proposals=64, rpn_batch=64, roi_batch=64)
    model = FR.create(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("running_mean") or name.endswith(".bias"):
                t.copy_(torch.randn(t.shape, generator=g) * 0.1)
            elif name.endswith("running_var") or (
                    name.endswith(".weight") and t.dim() == 1):
                t.copy_(torch.rand(t.shape, generator=g) * 0.5 + 0.75)
    images = torch.randint(0, 256, (2, size, size, 3), generator=g,
                           dtype=torch.uint8)
    xy = torch.rand(2, slots, 2, generator=g) * size * 0.6
    wh = torch.rand(2, slots, 2, generator=g) * size * 0.3 + 8
    gb = torch.cat([xy, torch.clamp(xy + wh, max=size)], -1)
    gc = torch.randint(0, 6, (2, slots), generator=g)
    gb[:, 5:] = 0.0
    gc[:, 5:] = -1
    draws = TFR.draw_train(2, len(FR.anchor_boxes(size)),
                           cfg.num_proposals + slots, g)
    return model, (images, gb, gc), draws


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,bars", [
    (torch.float32, (1e-3, 1e-2, 5e-2, 1e-3)),
    (torch.float64, (1e-9, 1e-9, 1e-7, 1e-9))])
def test_frcnn_train_step_card_matches_cpu(cuda, dtype, bars):
    """One small Faster R-CNN train step (blocks (1, 1, 1, 1), 128 px,
    batch 2, augment off) on the card with TF32 off against the CPU, the
    same weights and draws, the card's proposals replayed on the CPU: the
    losses within bars[0] relative and grad_norm within bars[1], every
    gradient leaf within bars[2] relative L2 (f32 noise through train-mode
    BatchNorm, the CPU's the larger), every running statistic within
    bars[3] x max|ref|."""
    model, batch, draws = _frcnn_train_inputs()
    props = []
    mc, gcard, _, sc = _frcnn_train_run(model, cuda, dtype, batch, draws,
                                        props)
    mr, gref, _, sr = _frcnn_train_run(model, torch.device("cpu"), dtype,
                                       batch, draws, props)
    for k, v in mr.items():
        bar = bars[1] if k == "grad_norm" else bars[0]
        assert abs(mc[k] - v) <= bar * abs(v), (k, mc[k], v)
    assert gcard.keys() == gref.keys() and len(gref) > 60
    for n, r in gref.items():
        err = ((gcard[n] - r).norm() / r.norm().clamp(min=1e-30)).item()
        assert err <= bars[2] or (gcard[n] - r).norm() <= 1e-9, (n, err)
    for n, r in sr.items():
        if "running_" in n:
            assert (sc[n] - r).abs().max() <= bars[3] * r.abs().max(), n


@pytest.mark.gpu
def test_frcnn_frozen_layers_keep_their_bits_on_the_card(cuda):
    """trainable_layers 3 on the card: the stem's and layer1's parameters
    get no gradient and keep their bits; their running statistics move."""
    model, batch, draws = _frcnn_train_inputs()
    _, grads, before, after = _frcnn_train_run(model, cuda, torch.float32,
                                               batch, draws, [], tl=3)
    frozen = [n for n in before if n.startswith(
        ("backbone.body.conv1.", "backbone.body.bn1.",
         "backbone.body.layer1."))]
    assert len(frozen) > 20
    for n in frozen:
        if n.endswith("num_batches_tracked"):
            continue
        if "running_" in n:
            assert not torch.equal(before[n], after[n]), n
        else:
            assert n not in grads and torch.equal(before[n], after[n]), n
    assert "backbone.body.layer2.0.conv1.weight" in grads


@pytest.mark.gpu
def test_frcnn_augment_step_launches_k1_once_a_step(cuda):
    """augment=True on the card: K1 launched once a step, every other hand
    kernel not at all; the step's default draws come from (seed, step)."""
    from robust_object_detection_tpu_torch.models import frcnn as FR
    from robust_object_detection_tpu_torch.train import frcnn as TFR
    model, (images, gb, gc), _ = _frcnn_train_inputs()
    model = model.to(cuda)
    state = TFR.init_state(model, TFR.make_optimizer()[0])
    step = TFR.make_train_step(model, 128, CorruptionConfig(), augment=True)
    fns = (C.conv3x3, C.conv3x3_wgrad, TF.front_inference, TF.front_fused,
           TF.front_fused_backward, FC.fused_random_corruption,
           ST.stem_fused_inference, ST.stem_fused, ST.stem_fused_backward,
           DF.ms_deform_attn_slots, DF.ms_deform_attn_backward,
           AS.auction_assignment, DF.ms_deform_attn_sorted_forward,
           DF.ms_deform_attn_sorted_backward, DF.stamp_scatter)
    for f in fns:
        f.launches = 0
    for _ in range(3):
        m = step(state, images.to(cuda), gb.to(cuda), gc.to(cuda), 7)
        assert all(torch.isfinite(v) for v in m.values())
    assert FC.fused_random_corruption.launches == 3
    assert all(f.launches == 0 for f in fns
               if f is not FC.fused_random_corruption)
    assert state.step == 3 and FR.FrcnnConfig is type(model.cfg)


@pytest.mark.gpu
def test_frcnn_load_checkpoint_lands_on_the_card(cuda, tmp_path):
    from robust_object_detection_tpu_torch.core.checkpoint import \
        CheckpointManager
    from robust_object_detection_tpu_torch.train import frcnn as TFR
    model, _, _ = _frcnn_train_inputs()
    CheckpointManager(tmp_path).save_best(1, model.state_dict(), 0.5)
    loaded = TFR.load_checkpoint(tmp_path, model.cfg)
    assert next(loaded.parameters()).device.type == "cuda"
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k].cpu(), v), k


# ── the YOLOv8 and RT-DETR trainers ──────────────────────────────────────

def _smoke():
    """chip_smoke.py of this checkout, loaded by path (an installed
    `chip_smoke` or `tests` elsewhere must not shadow it)."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _trainer_split(root, n_train, n_val, size=128):
    """chip_smoke.trainer_split at `size` px, 8 GT an image."""
    smoke = _smoke()
    smoke.IMG_SIZE, smoke.GT_PER_IMAGE = size, 8
    images = smoke.trainer_split(root, n_train, n_val, 0)
    return lambda sample: images[sample.image_id]


def _trainer_cfg():
    from robust_object_detection_tpu_torch.core.config import (
        ExperimentConfig, MeshConfig, TrainConfig)
    return ExperimentConfig(train=TrainConfig(seed=0),
                            mesh=MeshConfig(data=1, model=1))


@pytest.mark.gpu
def test_yolo_trainer_two_steps_on_the_card(cuda, tmp_path):
    """detector.train on the card (YOLOv8n, 128 px, batch 2, bf16,
    augment + HSV/flip, mosaic + affine, 4 train and 2 val images in
    memory): per step K1 1, K2-f train 1, K2-b 1, K3-f 4, K3-b 2 (the
    first C2f of YOLOv8n has one bottleneck, YOLOv8m's two); the
    validation forward K2-f eval 1, K3-f 2; history, best and last."""
    from robust_object_detection_tpu_torch.core import artifacts
    from robust_object_detection_tpu_torch.train import detector as D
    load = _trainer_split(tmp_path / "coco", 4, 2)
    fns = {"corrupt": FC.fused_random_corruption, "train": TF.front_fused,
           "bwd": TF.front_fused_backward, "eval": TF.front_inference,
           "conv": C.conv3x3, "wgrad": C.conv3x3_wgrad}
    for f in fns.values():
        f.launches = 0
    out = D.train(_trainer_cfg(), tmp_path / "coco", tmp_path / "run",
                  augment=True, variant="n", epochs=1, img_size=128,
                  batch_size=2, max_boxes=16, close_mosaic=0,
                  load_image=load)
    assert out["steps"] == 2 and math.isfinite(out["final_loss"])
    assert {k: f.launches for k, f in fns.items()} == {
        "corrupt": 2, "train": 2, "bwd": 2, "eval": 1, "conv": 10,
        "wgrad": 4}
    hist = artifacts.read_jsonl(tmp_path / "run" / "history.jsonl")
    assert [h["epoch"] for h in hist] == [1] and "mAP50" in hist[0]
    assert (tmp_path / "run" / "ckpt" / "best").exists()
    model = D.load_checkpoint(tmp_path / "run", "n", torch.bfloat16)
    assert next(model.parameters()).device.type == "cuda"


@pytest.mark.gpu
def test_rtdetr_trainer_two_steps_on_the_card(cuda, tmp_path):
    """rtdetr.train on the card (RT-DETR-L with two decoder layers, 128
    px, batch 2, bf16, augment + HSV/flip + CDN, 4 train and 2 val images
    in memory): per step K1 1, K4-f train 1, K4-b 1, K3-f 12, K3-b 6, K5
    2 + 2, K6 3; the validation forward K4-f eval 1, K3-f 6, K5 2."""
    from robust_object_detection_tpu_torch.core import artifacts
    from robust_object_detection_tpu_torch.train import rtdetr as RT
    load = _trainer_split(tmp_path / "coco", 4, 2)
    fns = {"corrupt": FC.fused_random_corruption, "train": ST.stem_fused,
           "bwd": ST.stem_fused_backward, "eval": ST.stem_fused_inference,
           "conv": C.conv3x3, "wgrad": C.conv3x3_wgrad,
           "k5": DF.ms_deform_attn_slots, "k5b": DF.ms_deform_attn_backward,
           "k6": AS.auction_assignment}
    for f in fns.values():
        f.launches = 0
    out = RT.train(_trainer_cfg(), tmp_path / "coco", tmp_path / "run",
                   augment=True, epochs=1, img_size=128, batch_size=2,
                   max_boxes=16, close_mosaic=0, load_image=load,
                   model_kwargs=dict(dec_layers=2))
    assert out["steps"] == 2 and math.isfinite(out["final_loss"])
    assert {k: f.launches for k, f in fns.items()} == {
        "corrupt": 2, "train": 2, "bwd": 2, "eval": 1, "conv": 30,
        "wgrad": 12, "k5": 6, "k5b": 4, "k6": 6}
    hist = artifacts.read_jsonl(tmp_path / "run" / "history.jsonl")
    assert [h["epoch"] for h in hist] == [1] and "matcher_capped" in hist[0]
    assert sorted(p.name for p in (tmp_path / "run" / "ckpt" / "last")
                  .iterdir()) == ["1"]


@pytest.mark.gpu
def test_ema_predict_card_matches_cpu(cuda):
    """train.detector.ema_forward (the EMA predict path of both trainers)
    on the card, f32 with TF32 off, against the CPU on one YOLOv8n with an
    EMA 5% away from its parameters: each head output within 1e-4 x
    max|ref|, far from the raw weights' outputs; the module's parameters
    and train mode untouched."""
    from robust_object_detection_tpu_torch.models import yolov8 as Y
    from robust_object_detection_tpu_torch.train import detector as D
    g = torch.Generator().manual_seed(0)
    outs = {}
    for dev in (torch.device("cpu"), cuda):
        model = Y.create(6, "n", torch.float32, dev,
                         torch.Generator().manual_seed(0), train=True)
        ema = {n: (p.detach().cpu() * (1 + 0.05 * torch.randn(
            p.shape, generator=torch.Generator().manual_seed(i)))).to(dev)
            for i, (n, p) in enumerate(model.named_parameters())
            if p.requires_grad}
        state = D.TrainState(model, ema, None, None)
        x = torch.rand(2, 128, 128, 3, generator=g.manual_seed(1)).to(dev)
        before = {k: t.clone() for k, t in model.state_dict().items()}
        with torch.backends.cudnn.flags(allow_tf32=False), \
                torch.inference_mode():
            outs[dev.type] = [t.float().cpu() for lvl in
                              D.ema_forward(state, x) for t in lvl]
            model.eval()
            raw = [t.float().cpu() for lvl in model(x) for t in lvl]
            model.train()
        assert model.training and all(
            torch.equal(before[k], t) for k, t in model.state_dict().items())
    for got, ref, r in zip(outs["cuda"], outs["cpu"], raw):
        assert _rel_err(got, ref) <= 1e-4
        assert _rel_err(r, ref) > 1e-3


def _nms_case(name):
    """(boxes, scores, classes, P, thr, class_aware) of a card NMS case,
    sorted candidates on the CPU."""
    if name == "sweep":           # multilabel_nms in the 8-pass sweep
        return NC.crowd(32, 30000, 6, seed=1) + (300, 0.7, True)
    if name == "sweep_ties":      # scores on 64 levels: long exact ties
        return NC.crowd(32, 30000, 6, seed=2, levels=64) + (300, 0.7, True)
    if name == "sweep_long":      # few objects: walks past most candidates
        return NC.crowd(32, 30000, 6, seed=3, objects=8, levels=256) \
            + (300, 0.7, True)
    if name in ("rpn", "rpn_train"):  # Faster R-CNN proposals, class-aware
        b = 8 if name == "rpn" else 2  # over 5 levels (int64), predict and
        bx, s, c = NC.crowd(b, 4096, 5, seed=4)      # train batches
        return bx, torch.sigmoid(s * 8 - 4), c.long(), 512, 0.7, True
    if name == "box":             # Faster R-CNN's detections
        return NC.crowd(8, 2048, 6, seed=5, levels=100) + (100, 0.5, True)
    if name == "agnostic":
        return NC.crowd(4, 5000, 1, seed=6, objects=50) + (300, 0.6, False)
    if name == "ulp":             # IoUs an ulp around thr, rounding boxes
        bx, s, iou = NC.ulp_pairs(4096, seed=7)
        return bx, s, torch.zeros(s.shape, dtype=torch.int32), 2, \
            NC.densest_iou(iou), False
    if name == "float64":         # Faster R-CNN's float64 step
        bx, s, c = NC.crowd(8, 4096, 5, seed=8, dtype="float64")
        return bx, s, c.long(), 512, 0.7, True
    # "spill": more kept boxes than shared memory holds beside a chunk
    bx, s, c = NC.crowd(1, 12000, 2, seed=10, objects=6000, jitter=0.0)
    return bx, s, c, 10000, 0.5, True


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["sweep", "sweep_ties", "sweep_long", "rpn",
                                  "rpn_train", "box", "agnostic", "ulp",
                                  "float64", "spill"])
def test_nms_walk_equals_the_loop(cuda, name):
    """One launch of nms_walk against the eager loop on the card, same
    sorted candidates: the same positions and scores slot for slot, the
    same detections, walk lengths as walk_lengths reads them from the
    loop's picks; one launch a call."""
    boxes, scores, classes, p, thr, aware = (
        t.to(cuda) if torch.is_tensor(t) else t for t in _nms_case(name))
    if name == "spill":
        assert NM.kernels.nms_plan(1, 12000, p)["kp_smem"] == 0
    ref_idx, ref_sval = NM._greedy_loop(boxes, scores, classes, p, thr,
                                        aware)
    before = NM._nms_core.launches
    stats = torch.zeros(boxes.shape[0], dtype=torch.int32, device=cuda)
    out = NM._nms_core(boxes, scores, classes, p, thr, aware, stats)
    idx, sval = NM._greedy_walk(boxes, scores, classes, p, thr, aware)
    torch.cuda.synchronize()
    assert NM._nms_core.launches == before + 2
    assert idx.dtype == torch.int64 and sval.dtype == scores.dtype
    assert torch.equal(idx, ref_idx) and torch.equal(sval, ref_sval)
    assert torch.equal(stats, NM.walk_lengths(ref_idx, ref_sval, scores))
    valid = ref_sval > 0
    assert torch.equal(out[3], valid)
    assert torch.equal(out[1], torch.where(valid, ref_sval, 0.0))
    assert torch.equal(out[0], torch.where(
        valid[..., None], torch.gather(boxes, 1, ref_idx[..., None].expand(
            -1, -1, 4)), 0.0))
    assert valid.any()


@pytest.mark.gpu
@pytest.mark.parametrize("box_t,score_t,class_t,aware", [
    (torch.bfloat16, torch.bfloat16, torch.int32, True),
    (torch.bfloat16, torch.float32, torch.int32, False),
    (torch.float32, torch.float64, torch.int32, True),
    (torch.float32, torch.float32, torch.float32, True)])
def test_nms_refuses_what_it_cannot_match(cuda, box_t, score_t, class_t,
                                          aware):
    """The walk takes float32 or float64 boxes and scores of one type and
    int32 or int64 classes (what every caller passes); anything else is
    refused before any launch."""
    boxes, scores, classes = NC.crowd(2, 100, 3)
    before = NM._nms_core.launches
    with pytest.raises(ValueError):
        NM._nms_core(boxes.to(cuda, box_t), scores.to(cuda, score_t),
                     classes.to(cuda, class_t), 10, 0.5, aware)
    assert NM._nms_core.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("multi_label", [True, False])
def test_predict_step_runs_the_nms_walk(cuda, multi_label, monkeypatch):
    """The YOLO predict step's NMS is one nms_walk launch a call, and its
    detections equal those of the same step with the eager loop."""
    from robust_object_detection_tpu_torch.models import yolov8 as Y
    from robust_object_detection_tpu_torch.train import detector as D
    model = Y.create(6, "n", torch.float32, cuda,
                     torch.Generator().manual_seed(0))
    x = (torch.rand(2, 128, 128, 3, generator=torch.Generator().manual_seed(
        1)) * 255).to(cuda)
    step = D.make_predict_step(128, multi_label=multi_label)
    before = NM._nms_core.launches
    got = step(model, x)
    torch.cuda.synchronize()
    assert NM._nms_core.launches == before + 1
    monkeypatch.setattr(NM, "_greedy_walk", lambda b, s, c, p, t, a, st=None:
                        NM._greedy_loop(b, s, c, p, t, a))
    ref = step(model, x)
    assert NM._nms_core.launches == before + 1
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert ref[3].any()
