"""3x3 stride-1 SAME convolution, NHWC (counterpart of ops/pallas_conv.py).

:func:`conv3x3` is the port of ``conv3x3_planes``, forward and backward,
as a ``torch.autograd.Function``:

  * forward: the hand-written kernel of ``csrc/conv3x3.cu`` (K3-f), a
    tensor-core implicit GEMM either way, routed by dtype: for bf16 the
    m16n8k16 kernel of ``csrc/conv3x3_tc.cuh``, for f32 the split-TF32
    kernel of ``csrc/conv3x3_tf32.cuh`` (each f32 operand as a TF32 hi
    plus a TF32 lo, three MMAs a product: f32 accuracy);
  * dX: the same forward kernel on dy with the filter flipped spatially
    and transposed (``k'[a, b, co, ci] = k[2-a, 2-b, ci, co]``), as the
    reference's ``_bwd`` does; these launches count as K3-f launches;
  * dW: :func:`conv3x3_wgrad`, the kernel of ``csrc/conv3x3_wgrad.cu``
    (K3-b), f32 out; bf16 inputs through ``csrc/conv3x3_tc.cuh``, f32
    inputs through the split-TF32 kernel of ``csrc/conv3x3_tf32.cuh``.

Every launch takes a plan computed in Python for its dtype
(``kernels.conv3x3_tc_plan``, ``kernels.wgrad_tc_plan``: tile split, chunk
count, 16-byte or element staging), which the CPU tests hold; a shape a
plan refuses raises.

On a CPU tensor each of the two kernels is replaced by its plain PyTorch
version (:func:`conv3x3_reference`, :func:`conv3x3_wgrad_reference`), the
versions the kernels are checked against on the card; the autograd
wiring (flip, transpose, dtypes) is the same on both devices. Any other
device, dtype, layout or shape raises: there is no fallback.

The filter may be given in x's dtype or in float32 (a trainer's master
weights): it is cast to x's dtype for the product, and its gradient comes
back in its own dtype, as the reference's kernel casts a float32 filter
inside and returns a float32 dk. The TPU kernel's planes layout (B, H, C,
W) existed for TPU lane padding only; the functions here take and return
NHWC.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import kernels


def conv3x3_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: x (B, H, W, Cin), w (3, 3, Cin, Cout) -> (B, H, W, Cout)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1)
    return y.permute(0, 2, 3, 1).contiguous()


def conv3x3_wgrad_reference(x: torch.Tensor,
                            dy: torch.Tensor) -> torch.Tensor:
    """Plain version of the filter gradient: x (B, H, W, Cin), dy (B, H, W,
    Cout) -> dk (3, 3, Cin, Cout), computed in x's dtype, returned in
    f32."""
    dk = torch.nn.grad.conv2d_weight(
        x.permute(0, 3, 1, 2), (dy.shape[3], x.shape[3], 3, 3),
        dy.permute(0, 3, 1, 2), padding=1)
    return dk.permute(2, 3, 1, 0).float().contiguous()


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:2]) != (3, 3):
        raise ValueError(f"conv3x3 takes x (B,H,W,Cin) and w (3,3,Cin,Cout), "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    if w.shape[2] != x.shape[3]:
        raise ValueError(f"conv3x3: x has {x.shape[3]} channels, "
                         f"w expects {w.shape[2]}")
    if (x.dtype not in (torch.float32, torch.bfloat16)
            or w.dtype not in (x.dtype, torch.float32)):
        raise ValueError(f"conv3x3 takes float32 or bfloat16 x and w of x's "
                         f"dtype or float32, got {x.dtype} and {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"conv3x3: x on {x.device}, w on {w.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("conv3x3 takes contiguous NHWC x and HWIO w")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv3x3 runs on cpu or cuda, got {x.device}")


def _forward(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K3-f (or its plain version on the CPU); w already in x's dtype.
    bf16 runs the m16n8k16 kernel, f32 the split-TF32 one."""
    if x.device.type == "cpu":
        return conv3x3_reference(x, w)
    b, h, wd, cin = x.shape
    cout = w.shape[3]
    y = torch.empty((b, h, wd, cout), dtype=x.dtype, device=x.device)
    args = (x.data_ptr(), w.data_ptr(), y.data_ptr(), b, h, wd, cin, cout)
    lib = kernels.load()
    with torch.cuda.device(x.device):       # launch on x's card and stream
        stream = kernels.stream_ptr(x.device)
        n_sm = kernels.sm_count(x.device)
        dtype = str(x.dtype).split(".")[-1]
        plan = kernels.conv3x3_tc_plan(dtype, b, h, wd, cin, cout, args[:2],
                                       n_sm)
        name = kernels.K3_ROUTES[dtype]["fwd"]
        err = getattr(lib, name)(*args, plan["nt"], plan["vec"],
                                 plan["blocks"], stream)
    kernels.check(err, name)
    conv3x3.launches += 1
    return y


def conv3x3_wgrad(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Filter gradient of the 3x3 SAME conv: x (B, H, W, Cin), dy (B, H, W,
    Cout), contiguous, one dtype (f32 or bf16) -> dk (3, 3, Cin, Cout) f32.
    On a CUDA tensor it launches K3-b; on a CPU tensor it runs
    :func:`conv3x3_wgrad_reference`."""
    if x.dim() != 4 or dy.dim() != 4 or x.shape[:3] != dy.shape[:3]:
        raise ValueError(f"conv3x3_wgrad takes x (B,H,W,Cin) and dy "
                         f"(B,H,W,Cout), got {tuple(x.shape)} and "
                         f"{tuple(dy.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16) or dy.dtype != x.dtype:
        raise ValueError(f"conv3x3_wgrad takes float32 or bfloat16 x and dy "
                         f"of one dtype, got {x.dtype} and {dy.dtype}")
    if x.device != dy.device or x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv3x3_wgrad runs on cpu or cuda with x and dy "
                         f"on one device, got {x.device} and {dy.device}")
    if not (x.is_contiguous() and dy.is_contiguous()):
        raise ValueError("conv3x3_wgrad takes contiguous NHWC x and dy")
    if x.device.type == "cpu":
        return conv3x3_wgrad_reference(x, dy)
    b, h, wd, cin = x.shape
    cout = dy.shape[3]
    dtype = str(x.dtype).split(".")[-1]
    plan = kernels.wgrad_tc_plan(dtype, b, h, wd, cin, cout,
                                 (x.data_ptr(), dy.data_ptr()),
                                 kernels.sm_count(x.device))
    name = kernels.K3_ROUTES[dtype]["wgrad"]
    chunks = plan["n_chunks"]
    part = torch.empty(chunks * 9 * cin * cout, dtype=torch.float32,
                       device=x.device)
    dk = torch.empty((3, 3, cin, cout), dtype=torch.float32, device=x.device)
    lib = kernels.load()
    with torch.cuda.device(x.device):
        args = (x.data_ptr(), dy.data_ptr(), part.data_ptr(), dk.data_ptr(),
                b, h, wd, cin, cout)
        stream = kernels.stream_ptr(x.device)
        err = getattr(lib, name)(*args, plan["mt"], plan["nt"], plan["vec"],
                                 chunks, stream)
    kernels.check(err, name)
    conv3x3_wgrad.launches += 1
    return dk


conv3x3_wgrad.launches = 0


class _Conv3x3(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w):
        wd = w.to(x.dtype)
        ctx.save_for_backward(x, wd)
        ctx.w_dtype = w.dtype
        return _forward(x, wd)

    @staticmethod
    def backward(ctx, dy):
        x, wd = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _forward(dy, wd.flip(0, 1).transpose(2, 3).contiguous())
        if ctx.needs_input_grad[1]:
            dw = conv3x3_wgrad(x, dy).to(ctx.w_dtype)
        return dx, dw


def conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 SAME conv, no bias: x (B, H, W, Cin) NHWC, w (3, 3, Cin,
    Cout) HWIO in x's dtype or f32 -> (B, H, W, Cout) in x's dtype,
    accumulated in f32. Differentiable in x and w (see the module doc)."""
    _check(x, w)
    return _Conv3x3.apply(x, w)


conv3x3.launches = 0
