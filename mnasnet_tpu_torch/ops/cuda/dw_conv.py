"""Fused depthwise conv + per-channel affine + optional ReLU or SiLU (``csrc/dw_conv.cu``).

Replaces the Pallas kernels ``_dw_s1_kernel`` and ``_dw_s2_kernel`` of
``mnasnet_tpu/ops/pallas/dw_conv.py`` (reached through ``_dw_fused_raw`` and
``depthwise_conv_fused_pallas``). The rounding is theirs: x is read in its own
dtype, the weights stay fp32, accumulation, scale and bias are fp32, and the
result is stored once in x's dtype.

On an H100 the op is memory-bound (2k² + 2 FLOP per output element against 4
bytes moved in bf16), so the kernel reads x once and writes y once: zero
padding happens in shared memory, never as a padded copy in device memory.
The source note in ``csrc/dw_conv.cu`` has the design; :func:`plan` picks a
block's band of output rows, its channel group, each thread's strip of
outputs and the rows computed side by side. C must be a multiple of 8 on the card (every MNASNet width is): the
wrapper raises for any other.

The kernel is the ``torch.library`` op ``mnasnet_tpu_torch::dw_conv_bn_act``,
so that ``torch.export``, ``torch.compile`` and fake tensors record the op
itself: its CPU impl is :func:`dw_conv_reference`, its CUDA impl launches the
kernel, its fake impl gives the output's shape. A tensor on any other device
finds no impl and raises; nothing falls back from one impl to another.
Each impl checks its arguments; :func:`dw_conv_bn_act` calls the op. It has no
gradient: where autograd would record it, it raises, and training reaches
the kernel through :func:`depthwise_conv_train` (``_dw_conv``,
``dw_conv.py:259-282``): the kernel with unit affine and no ReLU forward, and
the reference's XLA backward as torch ops (``ops/depthwise.py``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from mnasnet_tpu_torch.ops.cuda import _build

# The planner's rules (from the plan sweep of tools/tune_plans.py on an
# H100): shared memory of one block at most, its band of output rows, the
# threads of one step and the channel group it wants at least.
SMEM_BUDGET = 100 * 1024
BAND = 14
STEP_THREADS = 256
MIN_GROUP = 48
# Threads of one block at most (the kernel's __launch_bounds__).
MAX_THREADS = 512
# Outputs per thread along W that the kernel is built for, and the output
# rows a block may compute side by side.
STRIPS = (7, 2)
ROWS_SIDE_BY_SIDE = (7, 4, 2, 1)
_DTYPES = (torch.bfloat16, torch.float32)


class Plan(NamedTuple):
    th: int       # output rows of one block's band
    cg: int       # channels of one block (a multiple of 8 dividing C)
    r: int        # outputs per thread along W
    rp: int       # output rows computed side by side
    threads: int  # (cg / 8) * ceil(Wo / r) * rp
    smem: int     # shared-memory bytes of one block


def out_size(n: int, k: int, stride: int) -> int:
    return (n + 2 * (k // 2) - k) // stride + 1


def ring_cols(k: int, stride: int, wo: int, r: int) -> int:
    """Input columns of one ring row: the strips cover ceil(Wo/r)*r outputs."""
    return (-(-wo // r) * r - 1) * stride + k


def ring_rows(k: int, stride: int, th: int, rp: int) -> int:
    """Input rows of the ring: a step of rp output rows and the next step's
    rp*stride rows, or the whole band where that is fewer."""
    return min(k + stride * (2 * rp - 1), (th - 1) * stride + k)


def smem_bytes(k: int, stride: int, wo: int, th: int, cg: int, r: int, rp: int,
               elem_bytes: int) -> int:
    """Shared memory of one block; the same formula as ``dw_smem_bytes`` in
    ``csrc/dw_conv.cu``: fp32 weights [k*k][cg], scale and bias [2][cg], and
    the ring of input rows [ring_cols][cg] in the I/O dtype."""
    return ((k * k + 2) * cg * 4
            + ring_rows(k, stride, th, rp) * ring_cols(k, stride, wo, r) * cg * elem_bytes)


def make_plan(n: int, h: int, w: int, c: int, k: int, stride: int, elem_bytes: int,
              th: int, cg: int, r: int, rp: int) -> Plan:
    """The :class:`Plan` of explicit (th, cg, r, rp), with its thread count and
    shared memory; raises if the kernel cannot run it."""
    wo = out_size(w, k, stride)
    threads = cg // 8 * -(-wo // r) * rp
    smem = smem_bytes(k, stride, wo, th, cg, r, rp, elem_bytes)
    if cg % 8 or c % cg or r not in STRIPS or not 1 <= rp <= th or threads > MAX_THREADS \
            or smem > 232_448:
        raise ValueError(f"no dw launch for th={th} cg={cg} r={r} rp={rp} at W={w} C={c} "
                         f"k{k} s{stride}")
    return Plan(th, cg, r, rp, threads, smem)


@functools.lru_cache(maxsize=None)
def plan(n: int, h: int, w: int, c: int, k: int, stride: int, elem_bytes: int) -> Plan:
    """The launch plan of one shape (C a multiple of 8).

    th: ``BAND`` output rows. r: 7 outputs per thread at stride 1 where 7
    divides the row (every row of the model at 224 px), else 2. Then the
    most rows side by side (``ROWS_SIDE_BY_SIDE``) for which a channel group
    of at least ``MIN_GROUP`` (or all of C) keeps a step within
    ``STEP_THREADS`` threads and the block within ``SMEM_BUDGET``, with the
    widest such group; where no group that wide fits (fp32 rings at k = 5 or
    stride 2), the most rows side by side with the widest group that fits.
    The rules come from timing every plan of the 12 depthwise shapes of
    mnasnet1_0@224 at bs128 in bf16 on an H100
    (``python -m mnasnet_tpu_torch.tools.tune_plans``, PERF.md).
    """
    if c % 8:
        raise ValueError(f"the dw kernel needs C a multiple of 8, got {c}")
    ho, wo = out_size(h, k, stride), out_size(w, k, stride)
    th = min(BAND, ho)
    r = 7 if stride == 1 and wo % 7 == 0 else 2
    strips = -(-wo // r)
    fits = []  # (rows side by side, the widest group that fits)
    for rp in ROWS_SIDE_BY_SIDE:
        groups = [g for g in range(8, c + 1, 8)
                  if c % g == 0 and g // 8 * strips * rp <= STEP_THREADS
                  and smem_bytes(k, stride, wo, th, g, r, rp, elem_bytes) <= SMEM_BUDGET]
        if rp <= th and groups:
            fits.append((rp, max(groups)))
    wide = [(rp, g) for rp, g in fits if g >= min(MIN_GROUP, c)]
    rp, g = (wide or fits or [(1, 8)])[0]
    return make_plan(n, h, w, c, k, stride, elem_bytes, th, g, r, rp)


def dw_conv_reference(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, *, stride: int = 1,
                      relu: bool = True, silu: bool = False) -> torch.Tensor:
    """Plain PyTorch version: the depthwise conv in fp32 (weights not cast),
    then the affine and ReLU (or SiLU) in fp32, one cast to x's dtype."""
    k = w.shape[0]
    c = x.shape[-1]
    w4 = w.reshape(k, k, c).float().permute(2, 0, 1).unsqueeze(1)
    y = F.conv2d(x.permute(0, 3, 1, 2).float(), w4, stride=stride,
                 padding=k // 2, groups=c).permute(0, 2, 3, 1)
    y = y * scale.float() + bias.float()
    if relu:
        y = torch.relu(y)
    if silu:
        y = F.silu(y)
    return y.to(x.dtype).contiguous()


_PROTOTYPES = {
    "dw_conv_bn_act": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 12 + [ctypes.c_void_p],
                       ctypes.c_int),
    "dw_conv_smem_bytes": ([ctypes.c_int] * 8, ctypes.c_longlong),
}


def _lib() -> ctypes.CDLL:
    return _build.load("dw_conv", _PROTOTYPES)


def _check(x, w, scale, bias, stride, relu=False, silu=False):
    if relu and silu:
        raise ValueError("the dw epilogue takes one activation: relu or silu, not both")
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
                   bias: torch.Tensor, *, stride: int = 1, relu: bool = True,
                   silu: bool = False) -> torch.Tensor:
    """``y = act(dwconv_kxk(x, w) * scale + bias)`` with padding k//2; act is
    ReLU (``relu``), SiLU (``silu``, with ``relu=False``) or none.

    x (N, H, W, C) bf16 or fp32, NHWC; w (k, k, 1, C) fp32; scale, bias (C,)
    fp32; k in {3, 5}; stride in {1, 2}. Returns (N, Ho, Wo, C) in x's dtype.
    Calls the op ``mnasnet_tpu_torch::dw_conv_bn_act``: a CPU tensor takes
    :func:`dw_conv_reference`, a CUDA tensor launches the kernel
    (``dw_conv_bn_act.launches`` counts those launches) or raises.
    """
    _build.refuse_autograd("dw_conv_bn_act", x, w, scale, bias)
    return torch.ops.mnasnet_tpu_torch.dw_conv_bn_act.default(x, w, scale, bias, stride, relu,
                                                              silu)


def _dw_cuda(x, w, scale, bias, stride, relu, silu=False):
    """The op's CUDA impl: the op's and the kernel's checks, the plan, one
    launch. Every impl checks its arguments: an artifact calls the op
    directly."""
    _check(x, w, scale, bias, stride, relu, silu)
    if x.device.type != "cuda":
        raise ValueError(f"the dw kernel takes x on the card, not on {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"the dw kernel takes bf16 or fp32, not {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be a contiguous NHWC tensor")
    n, h, wd, c = x.shape
    if c % 8:
        raise ValueError(f"the dw kernel needs C a multiple of 8 (one 16-byte vector "
                         f"per thread), got {c}")
    if x.data_ptr() % 16:
        raise ValueError("x must start on a 16-byte boundary")
    k = w.shape[0]
    dev = x.device
    w32 = w.reshape(k, k, c).to(device=dev, dtype=torch.float32).contiguous()
    s32 = scale.to(device=dev, dtype=torch.float32).contiguous()
    b32 = bias.to(device=dev, dtype=torch.float32).contiguous()
    y = launch(x, w32, s32, b32, stride, 2 if silu else int(relu),
               plan(n, h, wd, c, k, stride, x.element_size()))
    dw_conv_bn_act.launches += 1
    return y


def _dw_cpu(x, w, scale, bias, stride, relu, silu=False):
    _check(x, w, scale, bias, stride, relu, silu)
    return dw_conv_reference(x, w, scale, bias, stride=stride, relu=relu, silu=silu)


def _dw_fake(x, w, scale, bias, stride, relu, silu=False):
    _check(x, w, scale, bias, stride, relu, silu)
    n, h, wd, c = x.shape
    k = w.shape[0]
    return x.new_empty((n, out_size(h, k, stride), out_size(wd, k, stride), c))


def launch(x, w32, s32, b32, stride: int, relu: int, p: Plan) -> torch.Tensor:
    """One launch of the kernel with plan ``p`` on checked, contiguous inputs
    (w32 (k, k, C), s32 and b32 (C,) fp32, on x's device); ``relu`` is the
    epilogue's activation: 0 (False) none, 1 (True) ReLU, 2 SiLU. Counts
    nothing: the plan sweep and the timings call it."""
    n, h, wd, c = x.shape
    k = w32.shape[0]
    y = torch.empty((n, out_size(h, k, stride), out_size(wd, k, stride), c),
                    dtype=x.dtype, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.dw_conv_bn_act(
            x.data_ptr(), w32.data_ptr(), s32.data_ptr(), b32.data_ptr(), y.data_ptr(),
            n, h, wd, c, k, stride, int(relu), int(x.dtype == torch.bfloat16),
            p.th, p.cg, p.r, p.rp, stream)
    _build.check(err, "dw_conv_bn_act")
    return y


dw_conv_bn_act.launches = 0

# The op. ``needs_exact_strides``: a compiler hands x over with the strides
# it has in eager mode (contiguous NHWC), never re-laid out.
_LIB = torch.library.Library("mnasnet_tpu_torch", "FRAGMENT")
_LIB.define("dw_conv_bn_act(Tensor x, Tensor w, Tensor scale, Tensor bias, int stride, "
            "bool relu, bool silu=False) -> Tensor", tags=(torch.Tag.needs_exact_strides,))
_LIB.impl("dw_conv_bn_act", _dw_cpu, "CPU")
_LIB.impl("dw_conv_bn_act", _dw_cuda, "CUDA")
torch.library.register_fake("mnasnet_tpu_torch::dw_conv_bn_act", _dw_fake, lib=_LIB)


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
        from mnasnet_tpu_torch.ops.depthwise import depthwise_backward

        return depthwise_backward(ctx, g)


def depthwise_conv_train(x: torch.Tensor, kernel: torch.Tensor, *, stride: int) -> torch.Tensor:
    """Differentiable depthwise conv (``depthwise_conv_pallas``,
    ``dw_conv.py:288``): :func:`dw_conv_bn_act` with unit scale, zero bias and
    no ReLU forward; ``dw_transposed_dx`` (dx in x's dtype, the kernel cast to
    it) and ``dw_grad_weights`` (summed in fp32) backward.

    x (N, H, W, C) NHWC; kernel (k, k, 1, C) fp32; padding k//2.
    """
    return _DepthwiseConv.apply(x, kernel, stride)
