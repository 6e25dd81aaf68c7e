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

Sync-BN (``replicas``, a :class:`~mnasnet_tpu_torch.parallel.Replicas`):
the moments are those of the global batch, summed over the replicas
(:func:`batch_moments`), and the backward sums the reduce's (2, C) output
over them, in place, between its launch and the dx kernel's, which then
divides by the global count (:func:`bn_bwd`). The kernels are the same.

The two kernels are the ``torch.library`` ops ``mnasnet_tpu_torch::bn_bwd_reduce``
and ``mnasnet_tpu_torch::bn_bwd_dx``, as the serving kernels are
(``ops/cuda/dw_conv.py``), so that ``torch.compile`` records them in the
backward it differentiates: the CPU impl is the plain PyTorch version
(``*_reference``), the CUDA impl launches the kernel or raises, the fake impl
gives the output's shape; nothing falls back from one to the other. A launch
adds one to the wrapper's ``launches``; a CUDA-graph replay launches without
it. With ``replicas`` the all-reduce between the two launches stays outside
the ops.

Under a CUDA-graph capture of a data-parallel step (NCCL), the region's
backward is captured whole: the reduce launch, the all-reduce of its
(2, C) sums on NCCL's stream, the dx launch. The global count the dx kernel
takes is an argument fixed on the host (:func:`~mnasnet_tpu_torch.parallel.
global_rows` checked it at the eager warm-up step), so a replay reads
nothing on the host.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from mnasnet_tpu_torch.ops.cuda import _build
from mnasnet_tpu_torch.parallel.dist import Replicas, all_reduce_sum, all_reduce_sum_, global_rows

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


def batch_moments(x: torch.Tensor, stats: str, replicas: Replicas | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 per-channel mean and biased variance of NHWC ``x`` (channels last).

    ``stats="one_pass"``: ``max(E[x²] − E[x]², 0)``; ``"two_pass"``:
    ``E[(x − μ)²]`` (``mnasnet_tpu/models/layers.py:206-213``). With
    ``replicas`` the expectations run over the global batch: ``one_pass``
    sums the (2, C) ``[Σx, Σx²]`` over the replicas in one collective,
    ``two_pass`` sums Σx and then Σ(x − μ)², and both divide by the global
    count (:func:`~mnasnet_tpu_torch.parallel.global_rows`). The sums are
    differentiable (the backward sums the gradient over the replicas). No
    host read once the warm-up step has checked the count: a CUDA graph
    captures the sums."""
    if stats not in STATS:
        raise ValueError(f"unknown BN stats {stats!r}; choices: {STATS}")
    x32 = x.float()
    axes = tuple(range(x.dim() - 1))
    if replicas is not None:
        n = global_rows(x.numel() // x.shape[-1], replicas)
        if stats == "one_pass":
            s = all_reduce_sum(torch.stack([x32.sum(dim=axes), x32.square().sum(dim=axes)]),
                               replicas) / n
            mean = s[0]
            return mean, torch.clamp_min(s[1] - mean.square(), 0.0)
        mean = all_reduce_sum(x32.sum(dim=axes), replicas) / n
        return mean, all_reduce_sum((x32 - mean).square().sum(dim=axes), replicas) / n
    mean = x32.mean(dim=axes)
    if stats == "one_pass":
        var = torch.clamp_min(x32.square().mean(dim=axes) - mean.square(), 0.0)
    else:
        var = (x32 - mean).square().mean(dim=axes)
    return mean, var


def _fwd_math(x, gamma, beta, eps: float, stats: str, replicas: Replicas | None = None):
    """``_fwd_math`` of ``bn_bwd.py:185``: factors in fp32, applied in x's
    dtype as two ops (one rounding after the multiply, one after the add)."""
    mean, var = batch_moments(x, stats, replicas)
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


def bn_bwd_dx_reference(x, dy, mean, inv, gamma, beta, dg, db, n: int | None = None):
    """Plain PyTorch version of the dx kernel: dx in x's dtype."""
    inv_n = 1.0 / (n or x.numel() // x.shape[-1])
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
    """The checks every impl of an op runs (an artifact or a compiled graph
    calls the op directly); the public wrappers also refuse autograd."""
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


# Per (device, stream): the reduce's partial sums and its tickets for eager
# launches. Every launch leaves the tickets at 0, so they are zeroed once,
# when made; launches on one stream run in turn and may share them. A larger
# plan replaces them, so a CUDA graph never holds these: a launch under
# capture takes its own, from the graph's pool, with its tickets zeroed by a
# memset captured before it (:func:`_scratch`).
_reduce_scratch: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


def _scratch(dev, stream: int, p: ReducePlan) -> tuple[torch.Tensor, torch.Tensor]:
    if torch.cuda.is_current_stream_capturing():
        # Freed after the launch like any temporary: the graph's pool keeps
        # the memory for its replays, and every replay zeroes the tickets.
        return (torch.empty(p.partial_floats, dtype=torch.float32, device=dev),
                torch.zeros(p.tiles, dtype=torch.int32, device=dev))
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
    the op has checked; the (2, C) fp32 sums (dγ, then dβ). Counts nothing:
    the op's CUDA impl counts its launches."""
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


def _reduce_cuda(x, dy, mean, inv, gamma, beta):
    """The reduce op's CUDA impl: the checks, the plan, one counted launch."""
    _check("bn_bwd_reduce", x, dy, (mean, inv, gamma, beta))
    if x.device.type != "cuda":
        raise ValueError(f"the reduce kernel takes x on the card, not on {x.device}")
    c = x.shape[-1]
    p = reduce_plan(x.numel() // c, c, x.element_size(), alignment(x.data_ptr(), dy.data_ptr()))
    out = launch_reduce(x, dy, mean, inv, gamma, beta, p)
    bn_bwd_reduce.launches += 1
    return out


def _reduce_cpu(x, dy, mean, inv, gamma, beta):
    _check("bn_bwd_reduce", x, dy, (mean, inv, gamma, beta))
    return torch.stack(bn_bwd_reduce_reference(x, dy, mean, inv, gamma, beta))


def _reduce_fake(x, dy, mean, inv, gamma, beta):
    _check("bn_bwd_reduce", x, dy, (mean, inv, gamma, beta))
    return x.new_empty((2, x.shape[-1]), dtype=torch.float32)


def _reduce(x, dy, mean, inv, gamma, beta) -> torch.Tensor:
    """The (2, C) fp32 sums (dγ, then dβ) of :func:`bn_bwd_reduce`, as one
    tensor: the op ``mnasnet_tpu_torch::bn_bwd_reduce``."""
    return torch.ops.mnasnet_tpu_torch.bn_bwd_reduce.default(x, dy, mean, inv, gamma, beta)


def bn_bwd_reduce(x, dy, mean, inv, gamma, beta) -> tuple[torch.Tensor, torch.Tensor]:
    """(dγ, dβ), fp32 (C,): ``Σ g·x̂`` and ``Σ g`` over N, H, W.

    x, dy (N, H, W, C) bf16 or fp32, NHWC, contiguous; mean, inv = rsqrt(var +
    eps), gamma, beta (C,) fp32. Calls the op
    ``mnasnet_tpu_torch::bn_bwd_reduce``: a CPU tensor takes
    :func:`bn_bwd_reduce_reference`; a CUDA tensor launches the kernel once
    (``bn_bwd_reduce.launches`` counts it) or raises. The two results are
    views of one (2, C) tensor. The sums are the same from run to run: their
    order is fixed by the shape, and no float atomics.
    """
    _build.refuse_autograd("bn_bwd_reduce", x, dy, mean, inv, gamma, beta)
    dg, db = _reduce(x, dy, mean, inv, gamma, beta).unbind()
    return dg, db


bn_bwd_reduce.launches = 0


def _dx_cuda(x, dy, mean, inv, gamma, beta, dg, db, n):
    """The dx op's CUDA impl: the checks, the plan, one counted launch."""
    vecs = (mean, inv, gamma, beta, dg, db)
    _check("bn_bwd_dx", x, dy, vecs)
    if x.device.type != "cuda":
        raise ValueError(f"the dx kernel takes x on the card, not on {x.device}")
    if n <= 0:
        raise ValueError(f"bn_bwd_dx needs a positive count, got n={n}")
    c = x.shape[-1]
    m = x.numel() // c
    tp, r, slabs = plan(m, c)
    dev = x.device
    v32 = _f32(vecs, dev)
    dx = torch.empty_like(x, memory_format=torch.contiguous_format)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.bn_bwd_dx(
            x.data_ptr(), dy.data_ptr(), *(v.data_ptr() for v in v32), dx.data_ptr(),
            m, c, 1.0 / n, tp, r, slabs, int(x.dtype == torch.bfloat16), stream)
    _build.check(err, "bn_bwd_dx")
    bn_bwd_dx.launches += 1
    return dx


def _dx_cpu(x, dy, mean, inv, gamma, beta, dg, db, n):
    _check("bn_bwd_dx", x, dy, (mean, inv, gamma, beta, dg, db))
    if n <= 0:
        raise ValueError(f"bn_bwd_dx needs a positive count, got n={n}")
    return bn_bwd_dx_reference(x, dy, mean, inv, gamma, beta, dg, db, n)


def _dx_fake(x, dy, mean, inv, gamma, beta, dg, db, n):
    _check("bn_bwd_dx", x, dy, (mean, inv, gamma, beta, dg, db))
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def bn_bwd_dx(x, dy, mean, inv, gamma, beta, dg, db, n: int | None = None) -> torch.Tensor:
    """dx = γ·inv·(g − dβ/n − x̂·dγ/n) in x's dtype, n = N·H·W unless given
    (sync-BN: the count over all replicas, with dγ and dβ their sums).

    The inputs of :func:`bn_bwd_reduce` plus its (dγ, dβ). Calls the op
    ``mnasnet_tpu_torch::bn_bwd_dx``: a CPU tensor takes
    :func:`bn_bwd_dx_reference`; a CUDA tensor launches the kernel
    (``bn_bwd_dx.launches`` counts those launches) or raises.
    """
    _build.refuse_autograd("bn_bwd_dx", x, dy, mean, inv, gamma, beta, dg, db)
    if n is not None and n <= 0:
        raise ValueError(f"bn_bwd_dx needs a positive count, got n={n}")
    return torch.ops.mnasnet_tpu_torch.bn_bwd_dx.default(
        x, dy, mean, inv, gamma, beta, dg, db, n or x.numel() // max(x.shape[-1], 1))


bn_bwd_dx.launches = 0

# The ops. ``needs_exact_strides``: a compiler hands x and dy over with the
# strides they have in eager mode (contiguous NHWC), never re-laid out.
_LIB = torch.library.Library("mnasnet_tpu_torch", "FRAGMENT")
_LIB.define("bn_bwd_reduce(Tensor x, Tensor dy, Tensor mean, Tensor inv, Tensor gamma, "
            "Tensor beta) -> Tensor", tags=(torch.Tag.needs_exact_strides,))
_LIB.define("bn_bwd_dx(Tensor x, Tensor dy, Tensor mean, Tensor inv, Tensor gamma, "
            "Tensor beta, Tensor dg, Tensor db, int n) -> Tensor",
            tags=(torch.Tag.needs_exact_strides,))
_LIB.impl("bn_bwd_reduce", _reduce_cpu, "CPU")
_LIB.impl("bn_bwd_reduce", _reduce_cuda, "CUDA")
_LIB.impl("bn_bwd_dx", _dx_cpu, "CPU")
_LIB.impl("bn_bwd_dx", _dx_cuda, "CUDA")
torch.library.register_fake("mnasnet_tpu_torch::bn_bwd_reduce", _reduce_fake, lib=_LIB)
torch.library.register_fake("mnasnet_tpu_torch::bn_bwd_dx", _dx_fake, lib=_LIB)


def bn_bwd(x, dy, mean, var, gamma, beta, eps: float, replicas: Replicas | None = None):
    """(dx, dγ, dβ) of y = relu((x − mean)·rsqrt(var + eps)·γ + β), mean and
    var the batch statistics of x (``_bn_bwd_pallas``, ``bn_bwd.py:129``).

    With ``replicas`` (sync-BN: mean and var are the global batch's) the
    reduce's (2, C) output is summed over the replicas in place, one
    collective, before the dx kernel runs with those global sums and the
    global count. The dγ and dβ returned are this replica's own sums, the
    gradient of its share of the loss, as for any other parameter: the step
    sums the gradients over the replicas. The three run from autograd's
    device thread; a capture of the step records them in this order."""
    inv = torch.rsqrt(var + eps)  # the forward's own rsqrt(var + eps)
    dy = dy.to(x.dtype).contiguous()
    sums = _reduce(x, dy, mean, inv, gamma, beta)
    own, n = sums, x.numel() // x.shape[-1]
    if replicas is not None:
        own = sums.clone()
        all_reduce_sum_([sums], replicas, "all_reduce (BN backward sums)")
        n = global_rows(n, replicas)
    dg, db = sums.unbind()
    dx = torch.ops.mnasnet_tpu_torch.bn_bwd_dx.default(x, dy, mean, inv, gamma, beta, dg, db, n)
    dg, db = own.unbind()
    return dx, dg.to(gamma.dtype), db.to(beta.dtype)


class _BNReluTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps, stats, replicas):
        x = x.contiguous()
        y, mean, var = _fwd_math(x, gamma, beta, eps, stats, replicas)
        ctx.save_for_backward(x, gamma, beta, mean, var)
        ctx.eps = eps
        ctx.replicas = replicas
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, gamma, beta, mean, var = ctx.saved_tensors
        dx, dgamma, dbeta = bn_bwd(x, dy, mean, var, gamma, beta, ctx.eps, ctx.replicas)
        return dx, dgamma, dbeta, None, None, None


def bn_relu_train(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  eps: float = 1e-5, stats: str = "one_pass",
                  replicas: Replicas | None = None):
    """Training-mode BN (batch statistics) + ReLU with the region backward.

    x (N, H, W, C) NHWC in the compute dtype; gamma, beta (C,) fp32. Returns
    (y, mean, biased_var); the caller applies the EMA and Bessel's correction
    to the statistics (``models/layers.py``, ``BatchNorm.relu_train_region``).
    ``replicas``: sync-BN over them (:func:`batch_moments`, :func:`bn_bwd`).
    """
    return _BNReluTrain.apply(x, gamma, beta, eps, stats, replicas)
