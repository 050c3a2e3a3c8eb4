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

import pytest
import torch

from robust_object_detection_tpu_torch.core.config import CorruptionConfig
from robust_object_detection_tpu_torch.ops import assignment as AS
from robust_object_detection_tpu_torch.ops import conv3x3 as C
from robust_object_detection_tpu_torch.ops import deform as DF
from robust_object_detection_tpu_torch.ops import fused_corrupt as FC
from robust_object_detection_tpu_torch.ops import stem as ST
from robust_object_detection_tpu_torch.ops import yolo_front as TF

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

# K3-b: 1e-3 x max|ref| in both dtypes. A product of two bf16 values is
# exact in f32, so the bf16 kernel differs from the f32 plain version on the
# same values only by the order of its f32 sums (2e-2 would pass a kernel
# that drops 1% of its pixels).
WGRAD_DTYPES = [(torch.float32, 1e-3), (torch.bfloat16, 1e-3)]
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
    takes the bf16 kernels' element staging (the plan says so) and still
    agrees with the plain versions: K3-f forward and dX, K3-b."""
    from robust_object_detection_tpu_torch import kernels
    b, h, w, cin, cout = 2, 37, 45, 48, 48
    g = torch.Generator().manual_seed(4)
    x = _misaligned(_rand(g, b, h, w, cin).to(cuda, dtype))
    dy = _misaligned(_rand(g, b, h, w, cout).to(cuda, dtype))
    k = _rand(g, 3, 3, cin, cout, scale=0.1).to(cuda, dtype)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    sm = kernels.sm_count(cuda)
    assert kernels.conv3x3_tc_plan(b, h, w, cin, cout,
                                   (x.data_ptr(), k.data_ptr()), sm)["vec"] == 0
    assert kernels.wgrad_tc_plan(b, h, w, cin, cout,
                                 (x.data_ptr(), dy.data_ptr()), sm)["vec"] == 0
    kflip = k.flip(0, 1).transpose(2, 3).contiguous()
    with torch.backends.cudnn.flags(allow_tf32=False):
        assert _rel_err(C.conv3x3(x, k),
                        C.conv3x3_reference(x.float(), k.float())) <= tol
        assert _rel_err(C.conv3x3(dy, kflip), C.conv3x3_reference(
            dy.float(), kflip.float())) <= tol
        dk = C.conv3x3_wgrad(x, dy)
        assert _rel_err(dk, C.conv3x3_wgrad_reference(x.float(),
                                                      dy.float())) <= 1e-3
    assert torch.equal(dk, C.conv3x3_wgrad(x, dy))


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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3),
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
    plan = kernels.front_plan(b, h, w, c1, c2, (x.data_ptr(), k1b.data_ptr(),
                                                k2b.data_ptr()), sm)
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
    plan = kernels.stem_plan(b, h, w, tuple(
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
    fw = kernels.stem_plan(b, h, w, tuple(t.data_ptr() for t in (x, *kb)), sm)
    assert [fw[k]["vec"] for k in ("p1", "c2a", "c2b", "p3")] == [0, 1, 1, 1]
    dy3 = torch.zeros(b, h // 4, w // 4, 32, dtype=torch.bfloat16,
                      device=cuda)
    bw = kernels.stem_bwd_plan(b, h, w, tuple(t.data_ptr() for t in (
        x, kb[1], kb[2], kb[3], dy3)), sm)
    assert (bw["vec"], bw["vec_x"]) == (1, 0)
    _stem_bf16_all_modes(x, params, cuda, 8e-2)


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
    on the same values: d(values) (f32 atomics, cast once), d(loc) and
    d(attn) within tol x max|ref|; d(loc) and d(attn), which use no
    atomics, keep their bits under a permutation of the queries."""
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
    else:                       # more valid GTs than queries
        b, q, m, n_valid = 2, 6, 9, 9
        cost = torch.rand(b, q, m, generator=g)
    valid = torch.zeros(b, m, dtype=torch.bool)
    valid[:, :n_valid] = True
    valid[0] = False            # an image with no valid GT
    cost = torch.where(valid[:, None, :], cost, torch.full_like(cost, AS.BIG))
    return cost, valid


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["normal", "odd", "capped", "crowded"])
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
    (((1024, 1024),), 1, 200, 1, 4, 4)]       # 2^20 cells: 64-bit sort keys


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
    (1, 1, 2, 5000, 1 << 20)])                # 64-bit sort keys
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
