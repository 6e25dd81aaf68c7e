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
``csrc/bn_bwd.cu`` has the kernels' design. :func:`reduce_plan` plans the
reduce's one launch, :func:`plan` the dx pass.

Each kernel wrapper runs its plain PyTorch version (``*_reference``) for a CPU
tensor and launches its kernel for a CUDA tensor, or raises; nothing falls
back from one to the other. A launch adds one to the wrapper's ``launches``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

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

# The reduce (``bn_reduce_kernel``): threads of a block (kReduceThreads in the
# source), the blocks it aims for (two per SM of an H100), the bytes of a row
# a tile aims to span, the bytes the finishing block of a tile may read at
# most (8 per slab and tile channel), and the shared memory of a block at
# most. The constants were fitted to ``tools/tune_plans.py --only bn_reduce``
# on the card (PERF.md).
REDUCE_THREADS = 256
REDUCE_BLOCKS = 2 * 132
TILE_BYTES = 64
FINISH_BYTES = 32 * 1024
REDUCE_SMEM_LIMIT = 48 * 1024


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


class ReducePlan(NamedTuple):
    """One launch of the reduce kernel: block (tile, slab) of ``threads``
    threads sums ``tg`` vectors of ``vec`` channels over ``rows_per_slab``
    rows, ``lanes`` rows side by side."""
    vec: int             # channels a thread loads as one vector
    vec_bytes: int       # 16, 8 or 4
    threads: int
    tg: int              # vectors (channel groups) of a tile
    tiles: int
    lanes: int           # row lanes of a block: threads // tg
    slabs: int
    rows_per_slab: int
    partial_floats: int  # scratch the launch writes: tiles x slabs x 2 x tile channels
    smem: int            # the tile's factors and the table of row-lane sums, bytes
    finish_bytes: int    # what the last block of a tile reads: 8 x slabs x tile channels


def alignment(*ptrs: int) -> int:
    """The largest power of two up to 16 that divides every address."""
    low = functools.reduce(lambda a, b: a | b, ptrs, 16)
    return low & -low


@functools.lru_cache(maxsize=None)
def reduce_plan(m: int, c: int, itemsize: int, align: int = 16) -> ReducePlan:
    """The reduce's launch for ``m`` rows of ``c`` channels of ``itemsize``
    bytes, with x and dy aligned to ``align`` bytes.

    The vector is the widest of 16, 8 and 4 bytes that holds at least two
    elements and divides a row and the alignment. Tiles split the row's
    vectors evenly into runs of about ``TILE_BYTES``, or into more tiles where
    ``REDUCE_BLOCKS`` blocks would make the finish read more than
    ``FINISH_BYTES`` (it reads 8 x slabs x tile channels, so x tiles²); slabs
    fill the card to ``REDUCE_BLOCKS`` unless a lane would walk fewer than
    ``MIN_ROWS_PER_THREAD`` rows, and are cut to keep the finish within
    ``FINISH_BYTES``."""
    if c <= 0 or c % 2 or m <= 0:
        raise ValueError(f"the reduce needs m > 0 rows and an even channel count, got {m}, {c}")
    vec_bytes = next((b for b in (16, 8, 4) if b // itemsize >= 2 and c % (b // itemsize) == 0
                      and align % b == 0), None)
    if vec_bytes is None:
        raise ValueError(f"x and dy must be aligned to {2 * itemsize} bytes, got {align}")
    vec = vec_bytes // itemsize
    groups = c // vec
    tiles = max(-(-groups // max(1, TILE_BYTES // vec_bytes)),
                math.ceil(math.sqrt(8 * REDUCE_BLOCKS * c / FINISH_BYTES)))
    tg = -(-groups // min(tiles, groups))
    lanes = REDUCE_THREADS // tg
    slabs = min(-(-REDUCE_BLOCKS // -(-groups // tg)), -(-m // (lanes * MIN_ROWS_PER_THREAD)),
                FINISH_BYTES // (8 * tg * vec))
    return make_reduce_plan(m, c, itemsize, vec_bytes, tg, max(1, slabs))


def make_reduce_plan(m: int, c: int, itemsize: int, vec_bytes: int, tg: int,
                     slabs: int) -> ReducePlan:
    """The plan with these free choices and what follows from them; slabs
    that would be left empty are dropped."""
    vec = vec_bytes // itemsize
    tiles = -(-(c // vec) // tg)
    lanes = REDUCE_THREADS // tg
    rows_per_slab = -(-m // slabs)
    slabs = -(-m // rows_per_slab)
    return ReducePlan(vec, vec_bytes, REDUCE_THREADS, tg, tiles, lanes, slabs, rows_per_slab,
                      tiles * slabs * 2 * tg * vec, tg * vec * 16 + lanes * (2 * tg * vec + 1) * 4,
                      8 * slabs * tg * vec)


_PROTOTYPES = {
    "bn_bwd_reduce": ([ctypes.c_void_p] * 9 + [ctypes.c_longlong] + [ctypes.c_int] * 6
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
    if dy.device != x.device:
        raise ValueError(f"dy must be on x's device {x.device}, not {dy.device}")
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
    """The vectors as contiguous fp32 on ``dev``, converting only those that
    are not."""
    return [v if v.dtype == torch.float32 and v.device == dev and v.is_contiguous()
            else v.to(device=dev, dtype=torch.float32).contiguous() for v in vecs]


# Per (device, stream): the reduce's partial sums and its tickets. Every
# launch leaves the tickets at 0, so they are zeroed once, when made; launches
# on one stream run in turn and may share them.
_reduce_scratch: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


def _scratch(dev, stream: int, p: ReducePlan) -> tuple[torch.Tensor, torch.Tensor]:
    key = (dev.index, stream)
    got = _reduce_scratch.get(key)
    if got is None or got[0].numel() < p.partial_floats or got[1].numel() < p.tiles:
        floats, tickets = (got[0].numel(), got[1].numel()) if got is not None else (0, 0)
        got = (torch.empty(max(floats, p.partial_floats), dtype=torch.float32, device=dev),
               torch.zeros(max(tickets, p.tiles), dtype=torch.int32, device=dev))
        _reduce_scratch[key] = got
    return got


def launch_reduce(x, dy, mean, inv, gamma, beta, p: ReducePlan) -> torch.Tensor:
    """One launch of the reduce kernel with plan ``p`` on CUDA tensors that
    :func:`bn_bwd_reduce` has checked; the (2, C) fp32 sums (dγ, then dβ).
    Counts nothing: the wrapper counts its launches."""
    dev = x.device
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return launch_reduce(x, dy, mean, inv, gamma, beta, p)
    vecs = _f32((mean, inv, gamma, beta), dev)
    c = x.shape[-1]
    out = torch.empty((2, c), dtype=torch.float32, device=dev)
    lib = _lib()
    # The raw handle of the current stream, without building a Stream object.
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    partial, tickets = _scratch(dev, stream, p)
    err = lib.bn_bwd_reduce(
        x.data_ptr(), dy.data_ptr(), *(v.data_ptr() for v in vecs), partial.data_ptr(),
        tickets.data_ptr(), out.data_ptr(), x.numel() // c, c, p.vec_bytes, p.threads, p.tg,
        p.slabs, int(x.dtype == torch.bfloat16), stream)
    _build.check(err, "bn_bwd_reduce")
    return out


def bn_bwd_reduce(x, dy, mean, inv, gamma, beta) -> tuple[torch.Tensor, torch.Tensor]:
    """(dγ, dβ), fp32 (C,): ``Σ g·x̂`` and ``Σ g`` over N, H, W.

    x, dy (N, H, W, C) bf16 or fp32, NHWC, contiguous; mean, inv = rsqrt(var +
    eps), gamma, beta (C,) fp32. A CPU tensor takes
    :func:`bn_bwd_reduce_reference`; a CUDA tensor launches the kernel once
    (``bn_bwd_reduce.launches`` counts it) or raises. The two results are
    views of one (2, C) tensor. The sums are the same from run to run: their
    order is fixed by the shape, and no float atomics.
    """
    _check("bn_bwd_reduce", x, dy, (mean, inv, gamma, beta))
    if x.device.type == "cpu":
        return bn_bwd_reduce_reference(x, dy, mean, inv, gamma, beta)
    c = x.shape[-1]
    p = reduce_plan(x.numel() // c, c, x.element_size(), alignment(x.data_ptr(), dy.data_ptr()))
    dg, db = launch_reduce(x, dy, mean, inv, gamma, beta, p).unbind()
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
