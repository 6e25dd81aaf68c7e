"""Depthwise-conv dispatch: a plain PyTorch route and the hand-written kernel.

Counterpart of ``mnasnet_tpu/ops/depthwise.py``:

  * ``impl="torch"``  — ``F.conv2d(groups=C)`` with the kernel cast to the
    compute dtype, as ``_xla_depthwise`` (``depthwise.py:45``) casts it, and
    autograd's backward. The counterpart of the reference's ``"xla"``.
  * ``impl="kernel"`` — the CUDA kernel of ``ops/cuda/dw_conv.py``, the
    counterpart of ``"pallas"``: :func:`depthwise_conv2d` runs it through its
    autograd Function (kernel forward, :func:`dw_transposed_dx` and
    :func:`dw_grad_weights` backward), :func:`depthwise_conv_bn_relu_fused`
    raw (inference). On a CPU tensor the wrapper runs the kernel's plain
    version.
  * ``impl="auto"``   — ``"kernel"`` on a CUDA tensor, ``"torch"`` elsewhere.
    The reference's ``auto -> XLA`` was a TPU measurement; this default is to
    be re-decided from the H100 times in ``PERF.md``.

Layout contract: x is NHWC, kernel is (k, k, 1, C) (HWIO with I == 1), the
JAX package's layouts.

The training-side routes ``taps``, ``taps2`` and ``hybrid`` are not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mnasnet_tpu_torch.ops.cuda.dw_conv import depthwise_conv_train, dw_conv_bn_act

IMPLS = ("auto", "kernel", "torch")
# The CLIs' --fused-kernels values: the port's routes and the reference's
# spellings of them.
CLI_IMPLS = {"auto": "auto", "kernel": "kernel", "torch": "torch", "pallas": "kernel",
             "xla": "torch"}


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
        return depthwise_conv_train(x, kernel, stride=stride)
    return _torch_depthwise(x, kernel, stride, k // 2 if padding is None else padding)


def dw_transposed_dx(g: torch.Tensor, kernel: torch.Tensor, stride: int, padding: int,
                     H: int, W: int) -> torch.Tensor:
    """dL/dx of a depthwise conv (``depthwise.py:93``): the transposed conv of
    g with the kernel cast to g's dtype; the output padding carries the stride
    remainder so that positions past the last window start get gradient.
    g (N, Ho, Wo, C) NHWC -> (N, H, W, C)."""
    k = kernel.shape[0]
    c = kernel.shape[-1]
    w = kernel.reshape(k, k, c).permute(2, 0, 1).unsqueeze(1).to(g.dtype)
    adj = ((H + 2 * padding - k) % stride, (W + 2 * padding - k) % stride)
    dx = F.conv_transpose2d(g.permute(0, 3, 1, 2), w, stride=stride, padding=padding,
                            output_padding=adj, groups=c)
    return dx.permute(0, 2, 3, 1)[:, :H, :W, :]


def dw_grad_weights(x: torch.Tensor, g: torch.Tensor, k: int, stride: int,
                    padding: int) -> torch.Tensor:
    """dL/dkernel summed in fp32 (``depthwise.py:117``):
    dw[u, v, c] = Σ xp[n, i·s+u, j·s+v, c]·g[n, i, j, c].

    The reference spells this as k² shifted elementwise reductions because
    XLA's depthwise weight gradient was slow on its TPU. In eager PyTorch the
    same spelling costs two full fp32 passes per tap (measured: 32 ms of
    device time and 600 launches per mnasnet1_0@224 bs128 step on an H100,
    PERF.md), so here it is one grouped weight-gradient convolution on the
    fp32 casts of x and g, with TF32 off: the same exact fp32 products,
    summed in fp32 in another order. x (N, H, W, C), g (N, Ho, Wo, C) NHWC
    -> (k, k, 1, C) fp32."""
    c = x.shape[-1]
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        w = torch.nn.grad.conv2d_weight(x.permute(0, 3, 1, 2).float(), (c, 1, k, k),
                                        g.permute(0, 3, 1, 2).float(), stride=stride,
                                        padding=padding, groups=c)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return w.permute(2, 3, 1, 0)


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
