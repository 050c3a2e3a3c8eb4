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

from robust_object_detection_tpu_torch.ops import conv3x3 as C
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
