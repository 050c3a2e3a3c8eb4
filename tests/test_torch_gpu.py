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
from robust_object_detection_tpu_torch.ops import conv3x3 as C
from robust_object_detection_tpu_torch.ops import fused_corrupt as FC
from robust_object_detection_tpu_torch.ops import yolo_front as TF

DTYPES = [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)]


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
                                   (3, 16, 16, 8, 16)])
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
                                   (2, 34, 46, 16, 24)])
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

WGRAD_DTYPES = [(torch.float32, 1e-3), (torch.bfloat16, 2e-2)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", WGRAD_DTYPES)
@pytest.mark.parametrize("shape", [(2, 64, 64, 48, 48), (2, 37, 45, 5, 20),
                                   (1, 9, 30, 3, 17)])
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
@pytest.mark.parametrize("shape", [(2, 64, 64, 48, 96), (2, 34, 46, 16, 24)])
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
@pytest.mark.parametrize("shape", [(2, 64, 64, 48, 96), (2, 34, 46, 16, 24)])
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
