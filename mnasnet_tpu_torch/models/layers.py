"""Core layers of the PyTorch MNASNet family, eval mode.

Counterpart of ``mnasnet_tpu/models/layers.py``. Parameter and buffer names
follow torchvision's MNASNet state_dict (``weight``, ``bias``,
``running_mean``, ``running_var``, ``num_batches_tracked``), so a torchvision
``.pth`` loads with a strict ``load_state_dict``.

Layout: every module takes and returns NCHW tensors in ``torch.channels_last``
memory. In that layout ``x.permute(0, 2, 3, 1)`` (:func:`nhwc`) is a
contiguous NHWC tensor without a copy; the 1x1 convs run as a matmul over
that view, and the kernels in ``ops/cuda`` take it as they are.

Train-mode BatchNorm (batch statistics and the running-stat EMA) and the
space-to-depth stem are training-side and are not in this package yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mnasnet_tpu_torch.ops.depthwise import depthwise_conv2d

BN_EPSILON = 1e-5


def conv_kernel_init_(weight: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Kaiming-normal, fan_out, relu: the reference's Conv2d init."""
    return nn.init.kaiming_normal_(weight, mode="fan_out", nonlinearity="relu",
                                   generator=generator)


def dense_kernel_init_(weight: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Kaiming-uniform, fan_out, sigmoid gain: the reference's final Linear init."""
    return nn.init.kaiming_uniform_(weight, mode="fan_out", nonlinearity="sigmoid",
                                    generator=generator)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW (channels_last memory) -> NHWC view."""
    return x.permute(0, 2, 3, 1)


def nchw(y: torch.Tensor) -> torch.Tensor:
    """NHWC -> NCHW view (channels_last memory when ``y`` is contiguous)."""
    return y.permute(0, 3, 1, 2)


class BatchNorm(nn.Module):
    """BatchNorm2d in eval mode, with torchvision's names and BN folding.

    The eval arithmetic is the reference's (``layers.py:230-235``): the
    factors ``inv = γ·rsqrt(σ²+ε)`` and ``shift = β − μ·inv`` are computed in
    fp32 and applied in the activation's dtype.
    """

    def __init__(self, features: int, eps: float = BN_EPSILON):
        super().__init__()
        self.num_features = features
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def folded(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Inference-time folded (scale, bias) in fp32: ``y = x*scale + bias``."""
        inv = self.weight * torch.rsqrt(self.running_var + self.eps)
        return inv, self.bias - self.running_mean * inv

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError("train-mode BatchNorm is not ported yet; call .eval()")
        inv, shift = self.folded()
        dt = x.dtype
        return x * inv.to(dt).view(1, -1, 1, 1) + shift.to(dt).view(1, -1, 1, 1)


class PointwiseConv(nn.Module):
    """Bias-free 1x1 conv, run as a matmul over the NHWC view (the
    reference's eval-mode ``dot`` lowering, ``layers.py:77-82``)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, 1, 1))

    def matrix(self) -> torch.Tensor:
        """(Cin, Cout) view, the JAX package's layout."""
        return self.weight[:, :, 0, 0].t()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nchw(torch.matmul(nhwc(x), self.matrix().to(x.dtype)))


class StemConv(nn.Module):
    """The 3x3 stride-2 RGB stem conv, bias-free (plain form only)."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, 3, 3, 3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight.to(x.dtype), stride=2, padding=1)


class DepthwiseConv(nn.Module):
    """Bias-free depthwise k x k conv with padding k//2; the weight keeps
    torch's (C, 1, k, k) layout. ``impl`` picks the route of
    :func:`mnasnet_tpu_torch.ops.depthwise.depthwise_conv2d`."""

    def __init__(self, channels: int, kernel_size: int, stride: int, impl: str = "auto"):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.impl = impl
        self.weight = nn.Parameter(torch.empty(channels, 1, kernel_size, kernel_size))

    def kernel(self) -> torch.Tensor:
        """(k, k, 1, C) view, the JAX package's layout."""
        return self.weight.permute(2, 3, 1, 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nchw(depthwise_conv2d(nhwc(x), self.kernel(), stride=self.stride,
                                     impl=self.impl))
