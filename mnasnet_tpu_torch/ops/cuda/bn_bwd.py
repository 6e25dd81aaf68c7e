"""Training BatchNorm + ReLU with the region backward on two kernels (``csrc/bn_bwd.cu``).

Counterpart of ``mnasnet_tpu/ops/pallas/bn_bwd.py``. :func:`bn_relu_train`
is the ``bn_relu_train`` custom VJP as a ``torch.autograd.Function``:

  forward   y = relu(x̂·γ + β), x̂ = (x − μ)·rsqrt(σ² + ε), batch μ and biased σ²
            (plain PyTorch ops, :func:`_fwd_math`); returns (y, μ, σ²)
  backward  g = dy·[y > 0] with the mask recomputed as the forward clamps it,
            dβ = Σg, dγ = Σg·x̂                     (:func:`bn_bwd_reduce`)
            dx = γ·rsqrt(σ² + ε)·(g − dβ/n − x̂·dγ/n)   (:func:`bn_bwd_dx`)

The statistics carry no gradient: they feed the running-stat EMA only. The
backward moves five plane-sized transfers (x and dy read twice, dx written
once) where autograd of the same forward keeps y and more; the source note in
``csrc/bn_bwd.cu`` has the kernels' design.

Each kernel wrapper runs its plain PyTorch version (``*_reference``) for a CPU
tensor and launches its kernel for a CUDA tensor, or raises; nothing falls
back from one to the other. A launch adds one to the wrapper's ``launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mnasnet_tpu_torch.ops.cuda import _build

_DTYPES = (torch.bfloat16, torch.float32)
STATS = ("one_pass", "two_pass")
# Threads of one block, and the blocks the planner aims for: eight per SM of
# an H100 (132 SMs).
THREADS = 256
TARGET_BLOCKS = 8 * 132
# Rows each thread walks at the least, so that a thread's per-channel setup
# is spread over some work.
MIN_ROWS_PER_THREAD = 8


def batch_moments(x: torch.Tensor, stats: str) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 per-channel mean and biased variance of NHWC ``x`` (channels last).

    ``stats="one_pass"``: ``max(E[x²] − E[x]², 0)``; ``"two_pass"``:
    ``E[(x − μ)²]`` (``mnasnet_tpu/models/layers.py:206-213``)."""
    if stats not in STATS:
        raise ValueError(f"unknown BN stats {stats!r}; choices: {STATS}")
    x32 = x.float()
    axes = tuple(range(x.dim() - 1))
    mean = x32.mean(dim=axes)
    if stats == "one_pass":
        var = torch.clamp_min(x32.square().mean(dim=axes) - mean.square(), 0.0)
    else:
        var = (x32 - mean).square().mean(dim=axes)
    return mean, var


def _fwd_math(x, gamma, beta, eps: float, stats: str):
    """``_fwd_math`` of ``bn_bwd.py:185``: factors in fp32, applied in x's
    dtype as two ops (one rounding after the multiply, one after the add)."""
    mean, var = batch_moments(x, stats)
    inv = gamma * torch.rsqrt(var + eps)
    shift = beta - mean * inv
    y = torch.relu(x * inv.to(x.dtype) + shift.to(x.dtype))
    return y, mean, var


def relu_mask_reference(x, mean, inv, gamma, beta) -> torch.Tensor:
    """The forward's ``y > 0``, bit for bit (``_relu_mask``, ``bn_bwd.py:47``):
    ``inv`` is ``rsqrt(var + eps)`` without γ."""
    inv_total = gamma * inv
    shift = beta - mean * inv_total
    return (x * inv_total.to(x.dtype) + shift.to(x.dtype)) > 0


def bn_bwd_reduce_reference(x, dy, mean, inv, gamma, beta):
    """Plain PyTorch version of the reduce kernel: (dγ, dβ) in fp32."""
    axes = tuple(range(x.dim() - 1))
    xhat = (x.float() - mean) * inv
    g = dy.float() * relu_mask_reference(x, mean, inv, gamma, beta).float()
    return (g * xhat).sum(dim=axes), g.sum(dim=axes)


def bn_bwd_dx_reference(x, dy, mean, inv, gamma, beta, dg, db):
    """Plain PyTorch version of the dx kernel: dx in x's dtype."""
    inv_n = 1.0 / (x.numel() // x.shape[-1])
    xhat = (x.float() - mean) * inv
    g = dy.float() * relu_mask_reference(x, mean, inv, gamma, beta).float()
    dx = (gamma * inv) * (g - inv_n * db - xhat * (inv_n * dg))
    return dx.to(x.dtype)


@functools.lru_cache(maxsize=None)
def plan(m: int, c: int) -> tuple[int, int, int]:
    """(TP, R, slabs): channel pairs and row lanes of one block, and the
    number of row slabs, for ``m`` rows of ``c`` channels.

    A block covers up to ``THREADS`` channel pairs, split evenly when C/2 is
    larger; the rest of its threads are row lanes. The slabs fill the grid
    to ``TARGET_BLOCKS`` unless that leaves a thread fewer than
    ``MIN_ROWS_PER_THREAD`` rows."""
    cp = c // 2
    tiles = -(-cp // THREADS)
    tp = -(-cp // tiles)
    r = max(1, THREADS // tp)
    slabs = max(1, min(-(-TARGET_BLOCKS // tiles), -(-m // (r * MIN_ROWS_PER_THREAD))))
    return tp, r, slabs


_PROTOTYPES = {
    "bn_bwd_reduce": ([ctypes.c_void_p] * 9 + [ctypes.c_longlong] + [ctypes.c_int] * 5
                      + [ctypes.c_void_p], ctypes.c_int),
    "bn_bwd_dx": ([ctypes.c_void_p] * 9 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float]
                  + [ctypes.c_int] * 4 + [ctypes.c_void_p], ctypes.c_int),
}


def _lib() -> ctypes.CDLL:
    return _build.load("bn_bwd", _PROTOTYPES)


def _check(what, x, dy, vecs):
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC, got shape {tuple(x.shape)}")
    if dy.shape != x.shape:
        raise ValueError(f"dy must have x's shape {tuple(x.shape)}, got {tuple(dy.shape)}")
    c = x.shape[-1]
    for v in vecs:
        if v.shape != (c,):
            raise ValueError(f"the per-channel vectors must be ({c},), got {tuple(v.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda, not {x.device}")
    if x.device.type == "cuda":
        _build.refuse_autograd(what, x, dy, *vecs)
        if x.dtype not in _DTYPES or dy.dtype != x.dtype:
            raise TypeError(f"{what} takes x and dy both bf16 or both fp32, not "
                            f"{x.dtype} and {dy.dtype}")
        if not (x.is_contiguous() and dy.is_contiguous()):
            raise ValueError("x and dy must be contiguous NHWC tensors")
        if c % 2:
            raise ValueError(f"{what} needs an even channel count, got {c}")


def _f32(vecs, dev):
    return [v.to(device=dev, dtype=torch.float32).contiguous() for v in vecs]


def bn_bwd_reduce(x, dy, mean, inv, gamma, beta) -> tuple[torch.Tensor, torch.Tensor]:
    """(dγ, dβ), fp32 (C,): ``Σ g·x̂`` and ``Σ g`` over N, H, W.

    x, dy (N, H, W, C) bf16 or fp32, NHWC; mean, inv = rsqrt(var + eps),
    gamma, beta (C,) fp32. A CPU tensor takes
    :func:`bn_bwd_reduce_reference`; a CUDA tensor launches the kernel (its
    two stages count as one launch in ``bn_bwd_reduce.launches``) or raises.
    The sums are the same from run to run: no atomics.
    """
    vecs = (mean, inv, gamma, beta)
    _check("bn_bwd_reduce", x, dy, vecs)
    if x.device.type == "cpu":
        return bn_bwd_reduce_reference(x, dy, *vecs)
    n, h, w, c = x.shape
    m = n * h * w
    tp, r, slabs = plan(m, c)
    dev = x.device
    v32 = _f32(vecs, dev)
    partial = torch.empty((2, slabs, c), dtype=torch.float32, device=dev)
    dg = torch.empty(c, dtype=torch.float32, device=dev)
    db = torch.empty(c, dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.bn_bwd_reduce(
            x.data_ptr(), dy.data_ptr(), *(v.data_ptr() for v in v32), partial.data_ptr(),
            dg.data_ptr(), db.data_ptr(), m, c, tp, r, slabs, int(x.dtype == torch.bfloat16),
            stream)
    _build.check(err, "bn_bwd_reduce")
    bn_bwd_reduce.launches += 1
    return dg, db


bn_bwd_reduce.launches = 0


def bn_bwd_dx(x, dy, mean, inv, gamma, beta, dg, db) -> torch.Tensor:
    """dx = γ·inv·(g − dβ/n − x̂·dγ/n) in x's dtype, n = N·H·W.

    The inputs of :func:`bn_bwd_reduce` plus its (dγ, dβ). A CPU tensor
    takes :func:`bn_bwd_dx_reference`; a CUDA tensor launches the kernel
    (``bn_bwd_dx.launches`` counts those launches) or raises.
    """
    vecs = (mean, inv, gamma, beta, dg, db)
    _check("bn_bwd_dx", x, dy, vecs)
    if x.device.type == "cpu":
        return bn_bwd_dx_reference(x, dy, *vecs)
    n, h, w, c = x.shape
    m = n * h * w
    tp, r, slabs = plan(m, c)
    dev = x.device
    v32 = _f32(vecs, dev)
    dx = torch.empty_like(x, memory_format=torch.contiguous_format)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.bn_bwd_dx(
            x.data_ptr(), dy.data_ptr(), *(v.data_ptr() for v in v32), dx.data_ptr(),
            m, c, 1.0 / m, tp, r, slabs, int(x.dtype == torch.bfloat16), stream)
    _build.check(err, "bn_bwd_dx")
    bn_bwd_dx.launches += 1
    return dx


bn_bwd_dx.launches = 0


def bn_bwd(x, dy, mean, var, gamma, beta, eps: float):
    """(dx, dγ, dβ) of y = relu((x − mean)·rsqrt(var + eps)·γ + β), mean and
    var the batch statistics of x (``_bn_bwd_pallas``, ``bn_bwd.py:129``)."""
    inv = torch.rsqrt(var + eps)  # the forward's own rsqrt(var + eps)
    dy = dy.to(x.dtype).contiguous()
    dg, db = bn_bwd_reduce(x, dy, mean, inv, gamma, beta)
    dx = bn_bwd_dx(x, dy, mean, inv, gamma, beta, dg, db)
    return dx, dg.to(gamma.dtype), db.to(beta.dtype)


class _BNReluTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps, stats):
        x = x.contiguous()
        y, mean, var = _fwd_math(x, gamma, beta, eps, stats)
        ctx.save_for_backward(x, gamma, beta, mean, var)
        ctx.eps = eps
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, gamma, beta, mean, var = ctx.saved_tensors
        dx, dgamma, dbeta = bn_bwd(x, dy, mean, var, gamma, beta, ctx.eps)
        return dx, dgamma, dbeta, None, None


def bn_relu_train(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  eps: float = 1e-5, stats: str = "one_pass"):
    """Training-mode BN (batch statistics) + ReLU with the region backward.

    x (N, H, W, C) NHWC in the compute dtype; gamma, beta (C,) fp32. Returns
    (y, mean, biased_var); the caller applies the EMA and Bessel's correction
    to the statistics (``models/layers.py``, ``BatchNorm.relu_train_region``).
    """
    return _BNReluTrain.apply(x, gamma, beta, eps, stats)
