"""Depthwise-conv dispatch: a plain PyTorch route, the hand-written kernel,
and the reference's training-side routes.

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
  * ``impl="taps"``   — ``_taps_depthwise`` (``depthwise.py:58-90``): the k²
    strided slices of the zero-padded input times the fp32 per-channel
    weight, accumulated in fp32 (u outer, v inner), cast back to x's dtype;
    autograd's backward. Plain PyTorch ops.
  * ``impl="taps2"``  — ``taps`` at stride 2, ``torch`` elsewhere.
  * ``impl="hybrid"`` — where ``_hybrid_wins`` holds (stride 2, H >= 28,
    ``depthwise.py:167-180``) the torch route's forward with the backward of
    ``_dw_hybrid_bwd`` (``depthwise.py:155-161``): :func:`dw_transposed_dx`
    and :func:`dw_grad_weights`; ``torch`` elsewhere.

The last three are training routes, as in the reference: in inference
:func:`depthwise_conv_bn_relu_fused` takes the torch route with the folded
affine for them, and only ``"kernel"`` reaches a kernel. The CLIs offer the
first three (:data:`CLI_IMPLS`); the others are library and tool knobs.

Layout contract: x is NHWC, kernel is (k, k, 1, C) (HWIO with I == 1), the
JAX package's layouts.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mnasnet_tpu_torch.ops.cuda.dw_conv import depthwise_conv_train, dw_conv_bn_act

IMPLS = ("auto", "kernel", "torch", "taps", "taps2", "hybrid")
# The routes of the BN+ReLU backward (``bn_bwd``): the first three of IMPLS.
BN_BWD_IMPLS = ("auto", "kernel", "torch")
# The CLIs' --fused-kernels values: the port's routes and the reference's
# spellings of them (the reference's flag offers auto, pallas and xla).
CLI_IMPLS = {"auto": "auto", "kernel": "kernel", "torch": "torch", "pallas": "kernel",
             "xla": "torch"}


def resolve_impl(impl: str, x: torch.Tensor) -> str:
    """The route ``impl`` takes for tensor ``x``: ``"auto"`` resolved to
    ``"kernel"`` or ``"torch"``, any other route as it is."""
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


def _taps_depthwise(x: torch.Tensor, kernel: torch.Tensor, stride: int,
                    padding: int) -> torch.Tensor:
    """y[n,i,j,c] = Σ_{u,v} xp[n, i·s+u, j·s+v, c]·w[u,v,c], xp zero-padded:
    each tap a strided slice of xp times the fp32 weight, summed in fp32 in
    the reference's order (u outer, v inner), then cast to x's dtype."""
    k = kernel.shape[0]
    n, h, w, c = x.shape
    ho = (h + 2 * padding - k) // stride + 1
    wo = (w + 2 * padding - k) // stride + 1
    xp = F.pad(x, (0, 0, padding, padding, padding, padding))
    w32 = kernel.float()
    acc = None
    for u in range(k):
        for v in range(k):
            win = xp[:, u:u + (ho - 1) * stride + 1:stride, v:v + (wo - 1) * stride + 1:stride]
            t = win.float() * w32[u, v, 0]
            acc = t if acc is None else acc + t
    return acc.to(x.dtype)


def hybrid_wins(h: int, k: int, stride: int = 1) -> bool:
    """Where ``"hybrid"`` takes its own backward (``_hybrid_wins``,
    ``depthwise.py:167-180``): the stride-2 layers of 28 rows or more."""
    return stride == 2 and h >= 28


def depthwise_backward(ctx, g):
    """The backward of a depthwise conv Function (the kernel's and
    ``"hybrid"``'s) from its saved (x, kernel) and ``ctx.stride``:
    :func:`dw_transposed_dx` in x's dtype and :func:`dw_grad_weights` summed
    in fp32, cast to the kernel's dtype (``_dw_hybrid_bwd``)."""
    x, kernel = ctx.saved_tensors
    k, s = kernel.shape[0], ctx.stride
    dx = dw = None
    if ctx.needs_input_grad[0]:
        dx = dw_transposed_dx(g.to(x.dtype), kernel, s, k // 2, x.shape[1], x.shape[2]).to(x.dtype)
    if ctx.needs_input_grad[1]:
        dw = dw_grad_weights(x, g, k, s, k // 2).to(kernel.dtype)
    return dx, dw, None


class _HybridDepthwise(torch.autograd.Function):
    """The torch route's forward with the port's depthwise backward
    (``_dw_conv_hybrid``, ``depthwise.py:147-164``)."""

    @staticmethod
    def forward(ctx, x, kernel, stride):
        ctx.save_for_backward(x, kernel)
        ctx.stride = stride
        return _torch_depthwise(x, kernel, stride, kernel.shape[0] // 2)

    backward = staticmethod(depthwise_backward)


def _kernel_padding(kernel: torch.Tensor, padding: int | None) -> int:
    k = kernel.shape[0]
    if padding is not None and padding != k // 2:
        raise ValueError(f"the dw kernel pads k//2 = {k // 2}, not {padding}")
    return k // 2


def depthwise_conv2d(x: torch.Tensor, kernel: torch.Tensor, *, stride: int = 1,
                     padding: int | None = None, impl: str = "auto") -> torch.Tensor:
    """Depthwise 2-D convolution, NHWC / (k, k, 1, C); padding defaults to k//2."""
    k = kernel.shape[0]
    route = resolve_impl(impl, x)
    if route == "kernel":
        _kernel_padding(kernel, padding)
        return depthwise_conv_train(x, kernel, stride=stride)
    pad = k // 2 if padding is None else padding
    if route == "taps" or (route == "taps2" and stride == 2):
        return _taps_depthwise(x, kernel, stride, pad)
    if route == "hybrid" and hybrid_wins(x.shape[1], k, stride):
        _kernel_padding(kernel, padding)
        return _HybridDepthwise.apply(x, kernel, stride)
    return _torch_depthwise(x, kernel, stride, pad)


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
    -> (k, k, 1, C) fp32.

    TF32 is a process-wide flag that a compiled graph does not replay, so the
    convolution is the op ``mnasnet_tpu_torch::dw_grad_weights``: a compiled
    backward calls it as it stands, and the flag is turned off around the
    convolution when it runs (or, in a CUDA graph, when it is captured)."""
    return torch.ops.mnasnet_tpu_torch.dw_grad_weights.default(x, g, k, stride, padding)


def _dw_grad_weights(x, g, k, stride, padding):
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


def _dw_grad_weights_fake(x, g, k, stride, padding):
    c = x.shape[-1]
    return x.new_empty((c, 1, k, k), dtype=torch.float32).permute(2, 3, 1, 0)


_LIB = torch.library.Library("mnasnet_tpu_torch", "FRAGMENT")
_LIB.define("dw_grad_weights(Tensor x, Tensor g, int k, int stride, int padding) -> Tensor")
_LIB.impl("dw_grad_weights", _dw_grad_weights, "CompositeExplicitAutograd")
torch.library.register_fake("mnasnet_tpu_torch::dw_grad_weights", _dw_grad_weights_fake,
                            lib=_LIB)


def depthwise_conv_bn_relu_fused(x: torch.Tensor, kernel: torch.Tensor,
                                 scale: torch.Tensor, bias: torch.Tensor, *,
                                 stride: int = 1, padding: int | None = None,
                                 relu: bool = True, impl: str = "auto",
                                 silu: bool = False) -> torch.Tensor:
    """Inference-time depthwise conv + folded-BN affine + optional ReLU, or
    SiLU with ``silu`` (and ``relu=False``).

    ``scale``/``bias`` are the folded BN factors
    (:meth:`mnasnet_tpu_torch.models.layers.BatchNorm.folded`). ``"kernel"``
    runs the dw kernel; every other route the torch route and the affine.
    """
    k = kernel.shape[0]
    if resolve_impl(impl, x) == "kernel":
        _kernel_padding(kernel, padding)
        return dw_conv_bn_act(x, kernel, scale, bias, stride=stride, relu=relu, silu=silu)
    y = _torch_depthwise(x, kernel, stride, k // 2 if padding is None else padding)
    y = y * scale.to(y.dtype) + bias.to(y.dtype)
    return F.silu(y) if silu else torch.relu(y) if relu else y
