"""ResNet backbone for the Faster R-CNN family (counterpart of
robust_object_detection_tpu/models/resnet.py).

Bottleneck-v1 layout (1x1 reduce, 3x3, 1x1 expand), the stride on the 3x3
with padding 1 and on the downsample branch's 1x1, as torchvision's; the
stem is a 7x7 / 2 conv with padding 3, then a 3x3 / 2 max-pool with
padding 1. Convs are ``F.conv2d`` (on the card cuDNN's) in the compute
``dtype`` (:func:`conv`: the f32 weights and the input cast to it, as
flax's ``nn.Conv(dtype=...)``), BatchNorm runs in f32 and outputs f32
whatever its input (eps 1e-5, flax's and torch's default; the reference's
``nn.BatchNorm(dtype=jnp.float32)``): from the running statistics in eval,
and with ``train=True`` with flax's train semantics (:func:`batch_norm`).
So in bf16 only the conv inputs are bf16; residual adds, ReLUs and the
stem's max-pool run on f32 tensors. Modules take and return NCHW-indexed tensors, in
channels_last memory on the card; every stride-2 layer gives ceil(H / 2),
as the reference's SAME-style explicit padding does.

Attribute names are torchvision's (``conv1``/``bn1``, ``layer{i}.{j}``,
``downsample.0/1``), so the ``state_dict`` keys are those of
``fasterrcnn_resnet50_fpn_v2``'s ``backbone.body``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import bn_train

# flax nn.BatchNorm's default momentum (torch momentum 0.01), which the
# reference's ResNet, FPN and box head keep
BN_MOMENTUM = 0.99


def batch_norm(y: torch.Tensor, bn: nn.BatchNorm2d,
               train: bool = False) -> torch.Tensor:
    """BatchNorm of NCHW y, output f32. Eval: the running statistics
    (whatever the module's ``training`` flag). Train: flax's train mode at
    momentum 0.99, f32 batch statistics with the fast variance, the
    running statistics updated in place."""
    if train:
        return bn_train(y, bn, torch.float32, BN_MOMENTUM)
    return F.batch_norm(y.float(), bn.running_mean, bn.running_var,
                        bn.weight, bn.bias, False, 0.0, bn.eps)


def conv(x: torch.Tensor, c: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Conv(dtype=dtype)``: input, weight and bias cast to dtype,
    the output in dtype; below f32 the bias is added to the rounded
    product, as flax adds it."""
    if dtype == torch.float32:       # the module's own call (its hooks)
        return c(x)
    y = F.conv2d(x.to(dtype), c.weight.to(dtype), None, c.stride, c.padding,
                 c.dilation, c.groups)
    return y if c.bias is None else y + c.bias.to(dtype)[:, None, None]


def linear(x: torch.Tensor, lin: nn.Linear,
           dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=dtype)``, the bias added as :func:`conv`
    adds it."""
    if dtype == torch.float32:
        return lin(x)
    return F.linear(x.to(dtype), lin.weight.to(dtype)) + lin.bias.to(dtype)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 x4, each with BN; ReLU after the sum."""

    def __init__(self, c_in: int, features: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        c_out = features * 4
        self.conv1 = nn.Conv2d(c_in, features, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(features)
        self.conv2 = nn.Conv2d(features, features, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(features)
        self.conv3 = nn.Conv2d(features, c_out, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(c_out)
        # the reference's `residual.shape != out.shape`
        self.downsample = (
            nn.Sequential(nn.Conv2d(c_in, c_out, 1, stride, bias=False),
                          nn.BatchNorm2d(c_out))
            if stride != 1 or c_in != c_out else None)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        d = self.dtype
        out = F.relu(batch_norm(conv(x, self.conv1, d), self.bn1, train))
        out = F.relu(batch_norm(conv(out, self.conv2, d), self.bn2, train))
        out = batch_norm(conv(out, self.conv3, d), self.bn3, train)
        residual = (x if self.downsample is None else
                    batch_norm(conv(x, self.downsample[0], d),
                               self.downsample[1], train))
        return F.relu(out + residual)


class ResNet(nn.Module):
    """Returns (C2, C3, C4, C5) at strides 4/8/16/32.

    trainable_layers is torchvision's ``trainable_backbone_layers`` (0..5,
    counted from the top; 5 trains everything, 3 freezes conv1 / bn1 /
    layer1): the gradient stops after the stem when it is below 5, and
    after stage i when i < 4 - trainable_layers (``.detach()`` where the
    reference has ``stop_gradient``), so frozen parameters get no gradient.
    Their BatchNorms still run in train mode and update their running
    statistics, as torch's ``model.train()`` and the reference do.
    dtype: the convs' compute type (the BatchNorms output f32)."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 trainable_layers: int = 5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.stage_sizes = tuple(stage_sizes)
        self.trainable_layers = trainable_layers
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        c_in = 64
        for i, n_blocks in enumerate(self.stage_sizes):
            width = 64 * 2 ** i
            blocks = []
            for j in range(n_blocks):
                stride = 2 if (j == 0 and i > 0) else 1
                blocks.append(BottleneckBlock(c_in, width, stride, dtype))
                c_in = width * 4
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor, train: bool = False
                ) -> Tuple[torch.Tensor, ...]:
        x = F.relu(batch_norm(conv(x, self.conv1, self.dtype), self.bn1,
                              train))
        x = F.max_pool2d(x, 3, 2, 1)
        if self.trainable_layers < 5:               # conv1 / bn1 frozen
            x = x.detach()
        feats = []
        for i in range(len(self.stage_sizes)):
            for block in getattr(self, f"layer{i + 1}"):
                x = block(x, train)
            if i < 4 - self.trainable_layers:       # layer{i+1} frozen
                x = x.detach()
            feats.append(x)
        return tuple(feats)


def frozen_param_labels(stage_sizes: Sequence[int], trainable_layers: int):
    """Backbone param-collection names frozen at this trainable_layers, in
    the reference's flax names: stem = Conv_0/BatchNorm_0, blocks =
    BottleneckBlock_k numbered consecutively across stages (used to mask
    weight decay off frozen params)."""
    if trainable_layers >= 5:
        return set()
    names = {"Conv_0", "BatchNorm_0"}
    n_frozen_stages = max(0, 4 - trainable_layers)
    for k in range(sum(stage_sizes[:n_frozen_stages])):
        names.add(f"BottleneckBlock_{k}")
    return names


def module_names(stage_sizes: Sequence[int], labels) -> List[str]:
    """The ResNet submodules (torchvision names: ``conv1``, ``bn1``,
    ``layer{s}.{j}``) that the flax labels of :func:`frozen_param_labels`
    name."""
    names = {"Conv_0": "conv1", "BatchNorm_0": "bn1"}
    k = 0
    for s, n_blocks in enumerate(stage_sizes):
        for j in range(n_blocks):
            names[f"BottleneckBlock_{k}"] = f"layer{s + 1}.{j}"
            k += 1
    return sorted(names[label] for label in labels)


def resnet50(dtype: torch.dtype = torch.float32) -> ResNet:
    return ResNet((3, 4, 6, 3), dtype=dtype)
