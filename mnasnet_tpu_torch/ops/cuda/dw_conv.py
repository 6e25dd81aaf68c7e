"""Fused depthwise conv + per-channel affine + optional ReLU (``csrc/dw_conv.cu``).

Replaces the Pallas kernels ``_dw_s1_kernel`` and ``_dw_s2_kernel`` of
``mnasnet_tpu/ops/pallas/dw_conv.py`` (reached through ``_dw_fused_raw`` and
``depthwise_conv_fused_pallas``). The rounding is theirs: x is read in its own
dtype, the weights stay fp32, accumulation, scale and bias are fp32, and the
result is stored once in x's dtype.

On an H100 the op is memory-bound (2k² + 2 FLOP per output element against 4
bytes moved in bf16), so the kernel reads x once and writes y once: zero
padding happens in shared memory, never as a padded copy in device memory.
The source note in ``csrc/dw_conv.cu`` has the design.

:func:`dw_conv_bn_act` runs :func:`dw_conv_reference` for a CPU tensor and
the kernel for a CUDA tensor; nothing falls back from one to the other. It has
no gradient: on a CUDA tensor that requires one it raises, and training
reaches the kernel through :func:`depthwise_conv_train` (``_dw_conv``,
``dw_conv.py:259-282``): the kernel with unit affine and no ReLU forward, and
the reference's XLA backward as torch ops (``ops/depthwise.py``).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from mnasnet_tpu_torch.ops.cuda import _build

# Shared memory one dw block plans for: small enough for several resident
# blocks on an SM (228 KB each), large enough for whole rows plus the halo.
SMEM_BUDGET = 48 * 1024
# Target channel tile; a tile is a multiple of 2 (the kernel moves pairs).
CHANNEL_TILE = 64
_DTYPES = (torch.bfloat16, torch.float32)


def out_size(n: int, k: int, stride: int) -> int:
    return (n + 2 * (k // 2) - k) // stride + 1


def smem_bytes(k: int, stride: int, wo: int, th: int, cb: int, elem_bytes: int) -> int:
    """Shared memory of one block; the same formula as ``dw_smem_bytes`` in
    ``csrc/dw_conv.cu``: fp32 weights [k*k][cb] + input rows with halo."""
    rows = (th - 1) * stride + k
    cols = (wo - 1) * stride + k
    return k * k * cb * 4 + rows * cols * cb * elem_bytes


@functools.lru_cache(maxsize=None)
def plan(n: int, h: int, w: int, c: int, k: int, stride: int,
         elem_bytes: int) -> tuple[int, int]:
    """(TH, CB): output rows and channels of one block.

    CB splits C into near-equal even tiles of at most ``CHANNEL_TILE``. TH is
    the tallest row tile within ``SMEM_BUDGET``, lowered until the grid has
    four blocks per SM of an H100 (132 SMs) where the shape allows it.
    """
    ho, wo = out_size(h, k, stride), out_size(w, k, stride)
    tiles = -(-c // CHANNEL_TILE)
    cb = -(-c // tiles)
    cb += cb % 2
    th = ho
    while th > 1 and smem_bytes(k, stride, wo, th, cb, elem_bytes) > SMEM_BUDGET:
        th -= 1
    while th > 1 and n * tiles * -(-ho // th) < 4 * 132:
        th -= 1
    if smem_bytes(k, stride, wo, th, cb, elem_bytes) > SMEM_BUDGET * 4:
        raise ValueError(f"a row of {wo} x {cb} channels does not fit shared memory")
    return th, cb


def dw_conv_reference(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, *, stride: int = 1,
                      relu: bool = True) -> torch.Tensor:
    """Plain PyTorch version: the depthwise conv in fp32 (weights not cast),
    then the affine and ReLU in fp32, one cast to x's dtype."""
    k = w.shape[0]
    c = x.shape[-1]
    w4 = w.reshape(k, k, c).float().permute(2, 0, 1).unsqueeze(1)
    y = F.conv2d(x.permute(0, 3, 1, 2).float(), w4, stride=stride,
                 padding=k // 2, groups=c).permute(0, 2, 3, 1)
    y = y * scale.float() + bias.float()
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype).contiguous()


_PROTOTYPES = {
    "dw_conv_bn_act": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_void_p],
                       ctypes.c_int),
    "dw_conv_smem_bytes": ([ctypes.c_int] * 6, ctypes.c_longlong),
}


def _lib() -> ctypes.CDLL:
    return _build.load("dw_conv", _PROTOTYPES)


def _check(x, w, scale, bias, stride):
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC, got shape {tuple(x.shape)}")
    c = x.shape[-1]
    k = w.shape[0]
    if w.numel() != k * k * c or w.shape[1] != k:
        raise ValueError(f"w must be (k, k, 1, C) or (k, k, C) for C={c}, got {tuple(w.shape)}")
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"scale and bias must be ({c},)")
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    if k not in (3, 5):
        raise ValueError(f"kernel size must be 3 or 5, got {k}")


def dw_conv_bn_act(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor, *, stride: int = 1, relu: bool = True) -> torch.Tensor:
    """``y = act(dwconv_kxk(x, w) * scale + bias)`` with padding k//2.

    x (N, H, W, C) bf16 or fp32, NHWC; w (k, k, 1, C) fp32; scale, bias (C,)
    fp32; k in {3, 5}; stride in {1, 2}. Returns (N, Ho, Wo, C) in x's dtype.
    A CPU tensor takes :func:`dw_conv_reference`; a CUDA tensor launches the
    kernel (``dw_conv_bn_act.launches`` counts those launches) or raises.
    """
    _check(x, w, scale, bias, stride)
    if x.device.type == "cpu":
        return dw_conv_reference(x, w, scale, bias, stride=stride, relu=relu)
    if x.device.type != "cuda":
        raise ValueError(f"dw_conv_bn_act runs on cpu or cuda, not {x.device}")
    _build.refuse_autograd("dw_conv_bn_act", x, w, scale, bias)
    if x.dtype not in _DTYPES:
        raise TypeError(f"the dw kernel takes bf16 or fp32, not {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be a contiguous NHWC tensor")
    n, h, wd, c = x.shape
    if c % 2:
        raise ValueError(f"the dw kernel needs an even channel count, got {c}")
    k = w.shape[0]
    dev = x.device
    w32 = w.reshape(k, k, c).to(device=dev, dtype=torch.float32).contiguous()
    s32 = scale.to(device=dev, dtype=torch.float32).contiguous()
    b32 = bias.to(device=dev, dtype=torch.float32).contiguous()
    th, cb = plan(n, h, wd, c, k, stride, x.element_size())
    y = torch.empty((n, out_size(h, k, stride), out_size(wd, k, stride), c),
                    dtype=x.dtype, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.dw_conv_bn_act(
            x.data_ptr(), w32.data_ptr(), s32.data_ptr(), b32.data_ptr(), y.data_ptr(),
            n, h, wd, c, k, stride, int(relu), int(x.dtype == torch.bfloat16),
            th, cb, stream)
    _build.check(err, "dw_conv_bn_act")
    dw_conv_bn_act.launches += 1
    return y


dw_conv_bn_act.launches = 0


class _DepthwiseConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel, stride):
        x = x.contiguous()
        c = x.shape[-1]
        ones = torch.ones(c, dtype=torch.float32, device=x.device)
        zeros = torch.zeros(c, dtype=torch.float32, device=x.device)
        ctx.save_for_backward(x, kernel)
        ctx.stride = stride
        return dw_conv_bn_act(x, kernel, ones, zeros, stride=stride, relu=False)

    @staticmethod
    def backward(ctx, g):
        from mnasnet_tpu_torch.ops.depthwise import dw_grad_weights, dw_transposed_dx

        x, kernel = ctx.saved_tensors
        k, s = kernel.shape[0], ctx.stride
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = dw_transposed_dx(g.to(x.dtype), kernel, s, k // 2,
                                  x.shape[1], x.shape[2]).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = dw_grad_weights(x, g, k, s, k // 2).to(kernel.dtype)
        return dx, dw, None


def depthwise_conv_train(x: torch.Tensor, kernel: torch.Tensor, *, stride: int) -> torch.Tensor:
    """Differentiable depthwise conv (``depthwise_conv_pallas``,
    ``dw_conv.py:288``): :func:`dw_conv_bn_act` with unit scale, zero bias and
    no ReLU forward; ``dw_transposed_dx`` (dx in x's dtype, the kernel cast to
    it) and ``dw_grad_weights`` (summed in fp32) backward.

    x (N, H, W, C) NHWC; kernel (k, k, 1, C) fp32; padding k//2.
    """
    return _DepthwiseConv.apply(x, kernel, stride)
