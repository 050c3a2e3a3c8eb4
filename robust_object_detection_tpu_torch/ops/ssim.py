"""SSIM / PSNR and the restoration loss (counterpart of
robust_object_detection_tpu/ops/ssim.py), NHWC float images in [0, 1].

SSIM is the reference's: an 11 x 11 gaussian window (sigma 1.5) applied
depthwise with ZERO padding of window // 2, so edge pixels see zero-padded
statistics, and the mean of the SSIM map over the batch.

The window must not run in TF32: the variance terms E[x^2] - E[x]^2
cancel catastrophically (the reference forces Precision.HIGHEST for it),
and a cuDNN f32 convolution runs in TF32 on the card under PyTorch's
default flags. Here the window is the reference's own f32 2-D window
(its weights sum to 1 - 6.6e-8, a bias the cancelling terms carry, so a
separable pass with other weights would not do), applied as one in-place
multiply-add a tap into a float64 accumulator on the five maps at once
(formed in float64 from the f32 images), and the SSIM map is formed in
float64: no flag of the process reaches it,
and its error stays below the reference's f32 conv's. The window's
adjoint is the same correlation (the window is symmetric).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """The 2-D window: outer product of the 1-D gaussian (coords
    arange(size) - size // 2), normalised to sum 1, in f32."""
    coords = np.arange(size, dtype=np.float32) - size // 2
    g = np.exp(-(coords ** 2) / (2 * sigma ** 2))
    w = np.outer(g, g)
    return (w / w.sum()).astype(np.float32)


def _correlate(x: torch.Tensor, w: np.ndarray) -> torch.Tensor:
    """Depthwise correlation of NHWC x with the k x k window w, zero
    padding k // 2 (torch conv2d padding=k//2), accumulated in float64:
    one in-place multiply-add a tap."""
    k = w.shape[0]
    h, wd = x.shape[1], x.shape[2]
    p = k // 2
    xp = F.pad(x, (0, 0, p, p, p, p))
    y = torch.zeros(x.shape, dtype=torch.float64, device=x.device)
    for dy in range(k):
        for dx in range(k):
            y.add_(xp[:, dy:dy + h, dx:dx + wd, :], alpha=float(w[dy, dx]))
    return y


class _Window(torch.autograd.Function):
    """The window (float64 out) and its adjoint. The gaussian window is
    symmetric, so the adjoint of a zero-padded correlation with it is the
    same correlation of the cotangent."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.w, ctx.dtype = w, x.dtype
        return _correlate(x, w)

    @staticmethod
    def backward(ctx, g):
        return _correlate(g, ctx.w).to(ctx.dtype), None


def ssim(pred: torch.Tensor, target: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM over the batch (NHWC), f32."""
    c1 = 0.01 ** 2
    c2 = 0.03 ** 2
    w = gaussian_window(window_size, sigma)
    p = pred.float().double()
    t = target.float().double()
    c = p.shape[-1]
    # the five maps through one window: mu1, mu2, E[p^2], E[t^2], E[pt]
    stats = _Window.apply(torch.cat([p, t, p * p, t * t, p * t], -1), w)
    mu1, mu2, e11, e22, e12 = stats.split(c, -1)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = e11 - mu1_sq
    sigma2_sq = e22 - mu2_sq
    sigma12 = e12 - mu12
    ssim_map = ((2 * mu12 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return ssim_map.mean().float()


def psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """10 log10(1 / MSE) on [0, 1] images; 100 dB at zero error."""
    return psnr_of_mse(torch.mean((pred.float() - target.float()) ** 2))


def psnr_of_mse(mse: torch.Tensor) -> torch.Tensor:
    return torch.where(mse == 0, torch.full_like(mse, 100.0),
                       10.0 * torch.log10(1.0 / torch.clamp(mse, min=1e-12)))


def restoration_loss(pred: torch.Tensor, target: torch.Tensor,
                     ssim_weight: float = 0.3) -> torch.Tensor:
    """L1 + w (1 - SSIM)."""
    l1 = torch.mean(torch.abs(pred - target))
    return l1 + ssim_weight * (1.0 - ssim(pred, target))
