"""Depthwise-conv dispatch: a plain PyTorch route and the hand-written kernel.

Counterpart of ``mnasnet_tpu/ops/depthwise.py`` for the eval-mode forward:

  * ``impl="torch"``  — ``F.conv2d(groups=C)`` with the kernel cast to the
    compute dtype, as ``_xla_depthwise`` (``depthwise.py:45``) casts it. The
    counterpart of the reference's ``"xla"``.
  * ``impl="kernel"`` — the CUDA kernel of ``ops/cuda/dw_conv.py``, the
    counterpart of ``"pallas"``. On a CPU tensor its wrapper runs the plain
    version of that kernel.
  * ``impl="auto"``   — ``"kernel"`` on a CUDA tensor, ``"torch"`` elsewhere.
    The reference's ``auto -> XLA`` was a TPU measurement; this default is to
    be re-decided from the H100 times in ``PERF.md``.

Layout contract: x is NHWC, kernel is (k, k, 1, C) (HWIO with I == 1), the
JAX package's layouts.

The training-side routes (``taps``, ``taps2``, ``hybrid``) and the backward
helpers (``dw_transposed_dx``, ``dw_grad_weights``) are not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mnasnet_tpu_torch.ops.cuda.dw_conv import dw_conv_bn_act

IMPLS = ("auto", "kernel", "torch")


def resolve_impl(impl: str, x: torch.Tensor) -> str:
    """The route ``impl`` takes for tensor ``x``: ``"kernel"`` or ``"torch"``."""
    if impl not in IMPLS:
        raise ValueError(f"unknown dw impl {impl!r}; choices: {IMPLS}")
    if impl == "auto":
        return "kernel" if x.is_cuda else "torch"
    return impl


def _torch_depthwise(x: torch.Tensor, kernel: torch.Tensor, stride: int,
                     padding: int) -> torch.Tensor:
    c = x.shape[-1]
    w = kernel.reshape(kernel.shape[0], kernel.shape[1], c).permute(2, 0, 1).unsqueeze(1)
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype), stride=stride,
                 padding=padding, groups=c)
    return y.permute(0, 2, 3, 1)


def _kernel_padding(kernel: torch.Tensor, padding: int | None) -> int:
    k = kernel.shape[0]
    if padding is not None and padding != k // 2:
        raise ValueError(f"the dw kernel pads k//2 = {k // 2}, not {padding}")
    return k // 2


def depthwise_conv2d(x: torch.Tensor, kernel: torch.Tensor, *, stride: int = 1,
                     padding: int | None = None, impl: str = "auto") -> torch.Tensor:
    """Depthwise 2-D convolution, NHWC / (k, k, 1, C); padding defaults to k//2."""
    k = kernel.shape[0]
    if resolve_impl(impl, x) == "kernel":
        _kernel_padding(kernel, padding)
        c = x.shape[-1]
        ones = torch.ones(c, dtype=torch.float32, device=x.device)
        zeros = torch.zeros(c, dtype=torch.float32, device=x.device)
        return dw_conv_bn_act(x, kernel, ones, zeros, stride=stride, relu=False)
    return _torch_depthwise(x, kernel, stride, k // 2 if padding is None else padding)


def depthwise_conv_bn_relu_fused(x: torch.Tensor, kernel: torch.Tensor,
                                 scale: torch.Tensor, bias: torch.Tensor, *,
                                 stride: int = 1, padding: int | None = None,
                                 relu: bool = True, impl: str = "auto") -> torch.Tensor:
    """Inference-time depthwise conv + folded-BN affine + optional ReLU.

    ``scale``/``bias`` are the folded BN factors
    (:meth:`mnasnet_tpu_torch.models.layers.BatchNorm.folded`).
    """
    k = kernel.shape[0]
    if resolve_impl(impl, x) == "kernel":
        _kernel_padding(kernel, padding)
        return dw_conv_bn_act(x, kernel, scale, bias, stride=stride, relu=relu)
    y = _torch_depthwise(x, kernel, stride, k // 2 if padding is None else padding)
    y = y * scale.to(y.dtype) + bias.to(y.dtype)
    return torch.relu(y) if relu else y
