"""Training BatchNorm + ReLU (or SiLU) on four kernels (``csrc/bn_bwd.cu``):
two for the region's forward, two for its backward.

Counterpart of ``mnasnet_tpu/ops/pallas/bn_bwd.py``. :func:`bn_relu_train`
is the ``bn_relu_train`` custom VJP as a ``torch.autograd.Function``:

  forward   y = relu(x̂·γ + β), x̂ = (x − μ)·rsqrt(σ² + ε), batch μ and biased σ²
            from the sums [Σ(x − s), Σ(x − s)²]          (:func:`bn_fwd_stats`;
            one launch with s = 0, or two under ``two_pass``: s = 0, then s = μ),
            y in one pass                                (:func:`bn_relu_apply`);
            returns (y, μ, σ²)
  backward  g = dy·[y > 0] with the mask recomputed as the forward clamps it,
            dβ = Σg, dγ = Σg·x̂                     (:func:`bn_bwd_reduce`)
            dx = γ·rsqrt(σ² + ε)·(g − dβ/n − x̂·dγ/n)   (:func:`bn_bwd_dx`)

With ``act="silu"`` (EfficientNet's BN+SiLU regions) the apply writes
y = silu(z), z = x̂·γ + β as the ReLU path rounds it, and the backward takes
g = dy·σ(z)·(1 + z·(1 − σ(z))) with z recomputed from x: the same kernels'
SiLU instantiations (their own CUDA names and C entries), the same plans, no
tensor saved beyond the ReLU region's. Each op's ``launches`` counts every
launch and ``launches_by_act`` splits them by activation.

The statistics carry no gradient: they feed the running-stat EMA only. The
forward reads x twice and writes y once (the reference's forward is plain
JAX, :func:`_fwd_math` here, which in PyTorch runs as some seven library
kernels); the backward moves five plane-sized transfers (x and dy read twice,
dx written once) where autograd of the same forward keeps y and more. The
source note in ``csrc/bn_bwd.cu`` has the kernels' design. :func:`stats_plan`
and :func:`reduce_plan` plan the two ticketed reductions, :func:`apply_plan`
the forward's normalise-and-ReLU pass, :func:`plan` the dx pass.

Sync-BN (``replicas``, a :class:`~mnasnet_tpu_torch.parallel.Replicas`):
the moments are those of the global batch, the forward's sums summed over
the replicas as :func:`batch_moments` sums its own (:func:`region_moments`:
the same collectives, which :func:`~mnasnet_tpu_torch.parallel.taped_sums`
records and replays under ``remat``), and the backward sums the reduce's (2, C) output
over them, in place, between its launch and the dx kernel's, which then
divides by the global count (:func:`bn_bwd`). The kernels are the same.
Under a spatial mesh x is a rank's band of rows: the sums are still
world-wide, the count is the band plan's (``parallel/dist.py:global_rows``),
and an empty band launches no kernel and adds zeros to the sums.

The four kernels are the ``torch.library`` ops ``mnasnet_tpu_torch::bn_fwd_stats``,
``::bn_relu_apply``, ``::bn_bwd_reduce`` and ``::bn_bwd_dx``, as the serving
kernels are (``ops/cuda/dw_conv.py``), so that ``torch.compile`` records them
in the step it traces: the CPU impl is the plain PyTorch version (the
arithmetic of :func:`batch_moments` and :func:`_fwd_math`, ``*_reference``),
the CUDA impl launches the kernel or raises, the fake impl gives the output's
shape; nothing falls back from one to the other. A launch adds one to the
wrapper's ``launches``; a CUDA-graph replay launches without it. With
``replicas`` the all-reduces between the launches stay outside the ops.

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
# The region's activations; each has its own kernels (``csrc/bn_bwd.cu``).
ACTS = ("relu", "silu")
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
# The forward's apply pass: the most vectors of a row one block's tile spans
# (a warp then covers whole rows, or 512 contiguous bytes of one).
APPLY_TILE_MAX = 32


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
    x32 = x.to(torch.promote_types(x.dtype, torch.float32))  # float64 stays float64
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
    """``_fwd_math`` of ``bn_bwd.py:185``, in plain PyTorch ops: factors in
    fp32, applied in x's dtype as two ops (one rounding after the multiply,
    one after the add)."""
    mean, var = batch_moments(x, stats, replicas)
    return bn_relu_apply_reference(x, mean, torch.rsqrt(var + eps), gamma, beta), mean, var


def bn_fwd_stats_reference(x, shift=None) -> torch.Tensor:
    """Plain PyTorch version of the stats kernel: the (2, C) sums
    ``[Σ(x − s), Σ(x − s)²]`` over N, H, W in fp32 (float64 stays float64),
    as :func:`batch_moments` sums them; ``shift`` None: s = 0."""
    x32 = x.to(torch.promote_types(x.dtype, torch.float32))
    d = x32 if shift is None else x32 - shift
    axes = tuple(range(x.dim() - 1))
    return torch.stack([d.sum(dim=axes), d.square().sum(dim=axes)])


def _pre_activation(x, mean, inv, gamma, beta) -> torch.Tensor:
    """``z = x·a + b`` in x's dtype, a = γ·inv and b = β − μ·a rounded to it
    first (``inv`` is ``rsqrt(var + eps)`` without γ): two PyTorch ops, one
    rounding after each."""
    a = gamma * inv
    b = beta - mean * a
    return x * a.to(x.dtype) + b.to(x.dtype)


def bn_relu_apply_reference(x, mean, inv, gamma, beta, act: str = "relu") -> torch.Tensor:
    """Plain PyTorch version of the apply kernel: ``relu(x·a + b)`` (or
    ``silu``) in x's dtype, a = γ·inv and b = β − μ·a rounded to it first
    (``inv`` is ``rsqrt(var + eps)`` without γ), so for ReLU ``y > 0`` is
    :func:`relu_mask_reference`."""
    z = _pre_activation(x, mean, inv, gamma, beta)
    return torch.nn.functional.silu(z) if act == "silu" else torch.relu(z)


def relu_mask_reference(x, mean, inv, gamma, beta) -> torch.Tensor:
    """The forward's ``y > 0``, bit for bit (``_relu_mask``, ``bn_bwd.py:47``):
    ``inv`` is ``rsqrt(var + eps)`` without γ."""
    return _pre_activation(x, mean, inv, gamma, beta) > 0


def act_grad_reference(x, dy, mean, inv, gamma, beta, act: str = "relu") -> torch.Tensor:
    """``g``, dy times the activation's derivative at the forward's z, in fp32:
    the ReLU mask, or σ(z)·(1 + z·(1 − σ(z))) at z rounded as the forward's."""
    if act == "silu":
        z = _pre_activation(x, mean, inv, gamma, beta).float()
        s = torch.sigmoid(z)
        return dy.float() * (s * (1.0 + z * (1.0 - s)))
    return dy.float() * relu_mask_reference(x, mean, inv, gamma, beta).float()


def bn_bwd_reduce_reference(x, dy, mean, inv, gamma, beta, act: str = "relu"):
    """Plain PyTorch version of the reduce kernel: (dγ, dβ) in fp32."""
    axes = tuple(range(x.dim() - 1))
    xhat = (x.float() - mean) * inv
    g = act_grad_reference(x, dy, mean, inv, gamma, beta, act)
    return (g * xhat).sum(dim=axes), g.sum(dim=axes)


def bn_bwd_dx_reference(x, dy, mean, inv, gamma, beta, dg, db, n: int | None = None,
                        act: str = "relu"):
    """Plain PyTorch version of the dx kernel: dx in x's dtype."""
    inv_n = 1.0 / (n or x.numel() // x.shape[-1])
    xhat = (x.float() - mean) * inv
    g = act_grad_reference(x, dy, mean, inv, gamma, beta, act)
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
    """One launch of the reduce kernel (or of the stats kernel, which shares
    its layout): block (tile, slab) of ``threads`` threads sums ``tg``
    vectors of ``vec`` channels over ``rows_per_slab`` rows, ``lanes`` rows
    side by side."""
    vec: int             # channels a thread loads as one vector
    vec_bytes: int       # 16, 8 or 4
    threads: int
    tg: int              # vectors (channel groups) of a tile
    tiles: int
    lanes: int           # row lanes of a block: threads // tg
    slabs: int
    rows_per_slab: int
    partial_floats: int  # scratch the launch writes: tiles x slabs x 2 x tile channels
    smem: int            # the tile's factors (the reduce's) and the table of row-lane sums, bytes
    finish_bytes: int    # what the last block of a tile reads: 8 x slabs x tile channels


def alignment(*ptrs: int) -> int:
    """The largest power of two up to 16 that divides every address."""
    low = functools.reduce(lambda a, b: a | b, ptrs, 16)
    return low & -low


def _vector_bytes(c: int, itemsize: int, align: int, what: str) -> int:
    """The widest of 16, 8 and 4 bytes that holds at least two elements and
    divides a row and the alignment."""
    vec_bytes = next((b for b in (16, 8, 4) if b // itemsize >= 2 and c % (b // itemsize) == 0
                      and align % b == 0), None)
    if vec_bytes is None:
        raise ValueError(f"{what} must be aligned to {2 * itemsize} bytes, got {align}")
    return vec_bytes


@functools.lru_cache(maxsize=None)
def reduce_plan(m: int, c: int, itemsize: int, align: int = 16, inputs: int = 2) -> ReducePlan:
    """The reduce's launch for ``m`` rows of ``c`` channels of ``itemsize``
    bytes, with x and dy aligned to ``align`` bytes; ``inputs=1``: the stats
    kernel's over x alone (:func:`stats_plan`).

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
    vec_bytes = _vector_bytes(c, itemsize, align, "x and dy" if inputs == 2 else "x")
    vec = vec_bytes // itemsize
    groups = c // vec
    tiles = max(-(-groups // max(1, TILE_BYTES // vec_bytes)),
                math.ceil(math.sqrt(8 * REDUCE_BLOCKS * c / FINISH_BYTES)))
    tg = -(-groups // min(tiles, groups))
    lanes = REDUCE_THREADS // tg
    slabs = min(-(-REDUCE_BLOCKS // -(-groups // tg)), -(-m // (lanes * MIN_ROWS_PER_THREAD)),
                FINISH_BYTES // (8 * tg * vec))
    return make_reduce_plan(m, c, itemsize, vec_bytes, tg, max(1, slabs), inputs)


def stats_plan(m: int, c: int, itemsize: int, align: int = 16) -> ReducePlan:
    """The stats kernel's launch for ``m`` rows of ``c`` channels: the
    reduce's rules (:func:`reduce_plan`) for one input, whose blocks keep no
    factors in shared memory."""
    return reduce_plan(m, c, itemsize, align, inputs=1)


def make_reduce_plan(m: int, c: int, itemsize: int, vec_bytes: int, tg: int,
                     slabs: int, inputs: int = 2) -> ReducePlan:
    """The plan with these free choices and what follows from them; slabs
    that would be left empty are dropped. ``inputs=1``: a stats launch,
    without the reduce's factors in shared memory."""
    vec = vec_bytes // itemsize
    tiles = -(-(c // vec) // tg)
    lanes = REDUCE_THREADS // tg
    rows_per_slab = -(-m // slabs)
    slabs = -(-m // rows_per_slab)
    factors = tg * vec * 16 if inputs == 2 else 0
    return ReducePlan(vec, vec_bytes, REDUCE_THREADS, tg, tiles, lanes, slabs, rows_per_slab,
                      tiles * slabs * 2 * tg * vec, factors + lanes * (2 * tg * vec + 1) * 4,
                      8 * slabs * tg * vec)


class ApplyPlan(NamedTuple):
    """One launch of the forward's normalise-and-ReLU kernel: block (tile,
    slab) of ``threads`` threads, ``lanes`` rows side by side of ``tg``
    vectors of ``vec`` channels, walks ``rows_per_slab`` rows."""
    vec: int
    vec_bytes: int
    threads: int
    tg: int
    tiles: int
    lanes: int
    slabs: int
    rows_per_slab: int


@functools.lru_cache(maxsize=None)
def apply_plan(m: int, c: int, itemsize: int, align: int = 16) -> ApplyPlan:
    """The apply kernel's launch for ``m`` rows of ``c`` channels of
    ``itemsize`` bytes, with x and y aligned to ``align`` bytes.

    The vector is the reduce's (:func:`reduce_plan`). A tile is the widest
    divisor of the row's vectors, at most ``APPLY_TILE_MAX``, that leaves at
    most a sixteenth of a block's ``THREADS`` threads idle (one vector always
    leaves none); slabs fill the grid to ``TARGET_BLOCKS`` unless a lane
    would walk fewer than ``MIN_ROWS_PER_THREAD`` rows."""
    if c <= 0 or c % 2 or m <= 0:
        raise ValueError(f"the apply pass needs m > 0 rows and an even channel count, "
                         f"got {m}, {c}")
    vec_bytes = _vector_bytes(c, itemsize, align, "x and y")
    vec = vec_bytes // itemsize
    groups = c // vec
    tg = max(t for t in range(1, min(groups, APPLY_TILE_MAX) + 1)
             if groups % t == 0 and 16 * (THREADS // t * t) >= 15 * THREADS)
    tiles, lanes = groups // tg, THREADS // tg
    slabs = max(1, min(-(-TARGET_BLOCKS // tiles), -(-m // (lanes * MIN_ROWS_PER_THREAD)), 65535))
    rows_per_slab = -(-m // slabs)
    return ApplyPlan(vec, vec_bytes, THREADS, tg, tiles, lanes, -(-m // rows_per_slab),
                     rows_per_slab)


_REDUCE_PROTO = ([ctypes.c_void_p] * 9 + [ctypes.c_longlong] + [ctypes.c_int] * 6
                 + [ctypes.c_void_p], ctypes.c_int)
_DX_PROTO = ([ctypes.c_void_p] * 9 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float]
             + [ctypes.c_int] * 4 + [ctypes.c_void_p], ctypes.c_int)
_APPLY_PROTO = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 6
                + [ctypes.c_void_p], ctypes.c_int)
_PROTOTYPES = {
    "bn_bwd_reduce": _REDUCE_PROTO,
    "bn_silu_bwd_reduce": _REDUCE_PROTO,
    "bn_bwd_dx": _DX_PROTO,
    "bn_silu_bwd_dx": _DX_PROTO,
    "bn_fwd_stats": ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 6
                     + [ctypes.c_void_p], ctypes.c_int),
    "bn_relu_apply": _APPLY_PROTO,
    "bn_silu_apply": _APPLY_PROTO,
}
# The C entry of each op by activation.
_ENTRIES = {"reduce": {"relu": "bn_bwd_reduce", "silu": "bn_silu_bwd_reduce"},
            "dx": {"relu": "bn_bwd_dx", "silu": "bn_silu_bwd_dx"},
            "apply": {"relu": "bn_relu_apply", "silu": "bn_silu_apply"}}


def _lib() -> ctypes.CDLL:
    return _build.load("bn_bwd", _PROTOTYPES)


def _check(what, x, dy, vecs, act: str = "relu"):
    """The checks every impl of an op runs (an artifact or a compiled graph
    calls the op directly); the public wrappers also refuse autograd. The
    forward's ops have no ``dy`` and hold their vectors to x's device."""
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}; choices: {ACTS}")
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC, got shape {tuple(x.shape)}")
    if dy is not None and dy.shape != x.shape:
        raise ValueError(f"dy must have x's shape {tuple(x.shape)}, got {tuple(dy.shape)}")
    c = x.shape[-1]
    for v in vecs:
        if v.shape != (c,):
            raise ValueError(f"the per-channel vectors must be ({c},), got {tuple(v.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda, not {x.device}")
    if dy is not None and dy.device != x.device:
        raise ValueError(f"dy must be on x's device {x.device}, not {dy.device}")
    if dy is None and any(v.device != x.device for v in vecs):
        raise ValueError(f"the per-channel vectors must be on x's device {x.device}")
    if x.device.type == "cuda":
        ios, names = ((x,), "x") if dy is None else ((x, dy), "x and dy")
        if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in ios):
            raise TypeError(f"{what} takes {names} in bf16 or fp32, one dtype, not "
                            f"{[t.dtype for t in ios]}")
        if not all(t.is_contiguous() for t in ios):
            raise ValueError(f"{names} must be contiguous NHWC tensors")
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
# memset captured before it (:func:`scratch`).
_reduce_scratch: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


def scratch(dev, stream: int, floats: int, tickets: int) -> tuple[torch.Tensor, torch.Tensor]:
    """At least ``floats`` fp32 of partial sums and ``tickets`` zeroed int32
    tickets for one ticketed reduction on ``stream`` (the SE reductions of
    ``ops/cuda/se.py`` share them)."""
    if torch.cuda.is_current_stream_capturing():
        # Freed after the launch like any temporary: the graph's pool keeps
        # the memory for its replays, and every replay zeroes the tickets.
        return (torch.empty(floats, dtype=torch.float32, device=dev),
                torch.zeros(tickets, dtype=torch.int32, device=dev))
    key = (dev.index, stream)
    got = _reduce_scratch.get(key)
    if got is None or got[0].numel() < floats or got[1].numel() < tickets:
        have = (got[0].numel(), got[1].numel()) if got is not None else (0, 0)
        got = (torch.empty(max(have[0], floats), dtype=torch.float32, device=dev),
               torch.zeros(max(have[1], tickets), dtype=torch.int32, device=dev))
        _reduce_scratch[key] = got
    return got


def _stream(dev) -> int:
    """The raw handle of the current stream, without building a Stream object."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


def _count(op, act: str) -> None:
    op.launches += 1
    op.launches_by_act[act] += 1


def launch_reduce(x, dy, mean, inv, gamma, beta, p: ReducePlan,
                  act: str = "relu") -> torch.Tensor:
    """One launch of the reduce kernel of ``act`` with plan ``p`` on CUDA
    tensors that the op has checked; the (2, C) fp32 sums (dγ, then dβ).
    Counts nothing: the op's CUDA impl counts its launches."""
    dev = x.device
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return launch_reduce(x, dy, mean, inv, gamma, beta, p, act)
    vecs = _f32((mean, inv, gamma, beta), dev)
    c = x.shape[-1]
    out = torch.empty((2, c), dtype=torch.float32, device=dev)
    lib = _lib()
    stream = _stream(dev)
    partial, tickets = scratch(dev, stream, p.partial_floats, p.tiles)
    err = getattr(lib, _ENTRIES["reduce"][act])(
        x.data_ptr(), dy.data_ptr(), *(v.data_ptr() for v in vecs), partial.data_ptr(),
        tickets.data_ptr(), out.data_ptr(), x.numel() // c, c, p.vec_bytes, p.threads, p.tg,
        p.slabs, int(x.dtype == torch.bfloat16), stream)
    _build.check(err, _ENTRIES["reduce"][act])
    return out


def _reduce_cuda(x, dy, mean, inv, gamma, beta, act="relu"):
    """The reduce op's CUDA impl: the checks, the plan, one counted launch."""
    _check("bn_bwd_reduce", x, dy, (mean, inv, gamma, beta), act)
    if x.device.type != "cuda":
        raise ValueError(f"the reduce kernel takes x on the card, not on {x.device}")
    c = x.shape[-1]
    p = reduce_plan(x.numel() // c, c, x.element_size(), alignment(x.data_ptr(), dy.data_ptr()))
    out = launch_reduce(x, dy, mean, inv, gamma, beta, p, act)
    _count(bn_bwd_reduce, act)
    return out


def _reduce_cpu(x, dy, mean, inv, gamma, beta, act="relu"):
    _check("bn_bwd_reduce", x, dy, (mean, inv, gamma, beta), act)
    return torch.stack(bn_bwd_reduce_reference(x, dy, mean, inv, gamma, beta, act))


def _reduce_fake(x, dy, mean, inv, gamma, beta, act="relu"):
    _check("bn_bwd_reduce", x, dy, (mean, inv, gamma, beta), act)
    return x.new_empty((2, x.shape[-1]), dtype=torch.float32)


def _reduce(x, dy, mean, inv, gamma, beta, act: str = "relu") -> torch.Tensor:
    """The (2, C) fp32 sums (dγ, then dβ) of :func:`bn_bwd_reduce`, as one
    tensor: the op ``mnasnet_tpu_torch::bn_bwd_reduce``."""
    return torch.ops.mnasnet_tpu_torch.bn_bwd_reduce.default(x, dy, mean, inv, gamma, beta, act)


def bn_bwd_reduce(x, dy, mean, inv, gamma, beta, act: str = "relu"
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dγ, dβ), fp32 (C,): ``Σ g·x̂`` and ``Σ g`` over N, H, W, with g = dy
    times ``act``'s derivative (:func:`act_grad_reference`).

    x, dy (N, H, W, C) bf16 or fp32, NHWC, contiguous; mean, inv = rsqrt(var +
    eps), gamma, beta (C,) fp32. Calls the op
    ``mnasnet_tpu_torch::bn_bwd_reduce``: a CPU tensor takes
    :func:`bn_bwd_reduce_reference`; a CUDA tensor launches the kernel once
    (``bn_bwd_reduce.launches`` counts it) or raises. The two results are
    views of one (2, C) tensor. The sums are the same from run to run: their
    order is fixed by the shape, and no float atomics.
    """
    _build.refuse_autograd("bn_bwd_reduce", x, dy, mean, inv, gamma, beta)
    dg, db = _reduce(x, dy, mean, inv, gamma, beta, act).unbind()
    return dg, db


bn_bwd_reduce.launches = 0
bn_bwd_reduce.launches_by_act = dict.fromkeys(ACTS, 0)


def _dx_cuda(x, dy, mean, inv, gamma, beta, dg, db, n, act="relu"):
    """The dx op's CUDA impl: the checks, the plan, one counted launch."""
    vecs = (mean, inv, gamma, beta, dg, db)
    _check("bn_bwd_dx", x, dy, vecs, act)
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
        err = getattr(lib, _ENTRIES["dx"][act])(
            x.data_ptr(), dy.data_ptr(), *(v.data_ptr() for v in v32), dx.data_ptr(),
            m, c, 1.0 / n, tp, r, slabs, int(x.dtype == torch.bfloat16), stream)
    _build.check(err, _ENTRIES["dx"][act])
    _count(bn_bwd_dx, act)
    return dx


def _dx_cpu(x, dy, mean, inv, gamma, beta, dg, db, n, act="relu"):
    _check("bn_bwd_dx", x, dy, (mean, inv, gamma, beta, dg, db), act)
    if n <= 0:
        raise ValueError(f"bn_bwd_dx needs a positive count, got n={n}")
    return bn_bwd_dx_reference(x, dy, mean, inv, gamma, beta, dg, db, n, act)


def _dx_fake(x, dy, mean, inv, gamma, beta, dg, db, n, act="relu"):
    _check("bn_bwd_dx", x, dy, (mean, inv, gamma, beta, dg, db), act)
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def _dx(x, dy, mean, inv, gamma, beta, dg, db, n: int, act: str = "relu") -> torch.Tensor:
    """The op ``mnasnet_tpu_torch::bn_bwd_dx``."""
    return torch.ops.mnasnet_tpu_torch.bn_bwd_dx.default(x, dy, mean, inv, gamma, beta, dg, db,
                                                         n, act)


def bn_bwd_dx(x, dy, mean, inv, gamma, beta, dg, db, n: int | None = None,
              act: str = "relu") -> torch.Tensor:
    """dx = γ·inv·(g − dβ/n − x̂·dγ/n) in x's dtype, n = N·H·W unless given
    (sync-BN: the count over all replicas, with dγ and dβ their sums), g as
    :func:`bn_bwd_reduce` takes it for ``act``.

    The inputs of :func:`bn_bwd_reduce` plus its (dγ, dβ). Calls the op
    ``mnasnet_tpu_torch::bn_bwd_dx``: a CPU tensor takes
    :func:`bn_bwd_dx_reference`; a CUDA tensor launches the kernel
    (``bn_bwd_dx.launches`` counts those launches) or raises.
    """
    _build.refuse_autograd("bn_bwd_dx", x, dy, mean, inv, gamma, beta, dg, db)
    if n is not None and n <= 0:
        raise ValueError(f"bn_bwd_dx needs a positive count, got n={n}")
    return _dx(x, dy, mean, inv, gamma, beta, dg, db, n or x.numel() // max(x.shape[-1], 1),
               act)


bn_bwd_dx.launches = 0
bn_bwd_dx.launches_by_act = dict.fromkeys(ACTS, 0)

# The ops. ``needs_exact_strides``: a compiler hands x and dy over with the
# strides they have in eager mode (contiguous NHWC), never re-laid out.
_LIB = torch.library.Library("mnasnet_tpu_torch", "FRAGMENT")
_LIB.define("bn_bwd_reduce(Tensor x, Tensor dy, Tensor mean, Tensor inv, Tensor gamma, "
            "Tensor beta, str act=\"relu\") -> Tensor", tags=(torch.Tag.needs_exact_strides,))
_LIB.define("bn_bwd_dx(Tensor x, Tensor dy, Tensor mean, Tensor inv, Tensor gamma, "
            "Tensor beta, Tensor dg, Tensor db, int n, str act=\"relu\") -> Tensor",
            tags=(torch.Tag.needs_exact_strides,))
_LIB.impl("bn_bwd_reduce", _reduce_cpu, "CPU")
_LIB.impl("bn_bwd_reduce", _reduce_cuda, "CUDA")
_LIB.impl("bn_bwd_dx", _dx_cpu, "CPU")
_LIB.impl("bn_bwd_dx", _dx_cuda, "CUDA")
torch.library.register_fake("mnasnet_tpu_torch::bn_bwd_reduce", _reduce_fake, lib=_LIB)
torch.library.register_fake("mnasnet_tpu_torch::bn_bwd_dx", _dx_fake, lib=_LIB)


def launch_stats(x, shift, p: ReducePlan) -> torch.Tensor:
    """One launch of the stats kernel with plan ``p`` on a CUDA tensor that
    the op has checked; the (2, C) fp32 sums. Counts nothing: the op's CUDA
    impl counts its launches."""
    dev = x.device
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return launch_stats(x, shift, p)
    c = x.shape[-1]
    shift = None if shift is None else _f32((shift,), dev)[0]
    out = torch.empty((2, c), dtype=torch.float32, device=dev)
    stream = _stream(dev)
    partial, tickets = scratch(dev, stream, p.partial_floats, p.tiles)
    err = _lib().bn_fwd_stats(
        x.data_ptr(), None if shift is None else shift.data_ptr(), partial.data_ptr(),
        tickets.data_ptr(), out.data_ptr(), x.numel() // c, c, p.vec_bytes, p.threads, p.tg,
        p.slabs, int(x.dtype == torch.bfloat16), stream)
    _build.check(err, "bn_fwd_stats")
    return out


def _stats_vecs(shift):
    return () if shift is None else (shift,)


def _stats_cuda(x, shift):
    """The stats op's CUDA impl: the checks, the plan, one counted launch."""
    _check("bn_fwd_stats", x, None, _stats_vecs(shift))
    if x.device.type != "cuda":
        raise ValueError(f"the stats kernel takes x on the card, not on {x.device}")
    c = x.shape[-1]
    out = launch_stats(x, shift, stats_plan(x.numel() // c, c, x.element_size(),
                                            alignment(x.data_ptr())))
    bn_fwd_stats.launches += 1
    return out


def _stats_cpu(x, shift):
    _check("bn_fwd_stats", x, None, _stats_vecs(shift))
    return bn_fwd_stats_reference(x, shift)


def _stats_fake(x, shift):
    _check("bn_fwd_stats", x, None, _stats_vecs(shift))
    return x.new_empty((2, x.shape[-1]), dtype=torch.promote_types(x.dtype, torch.float32))


def bn_fwd_stats(x, shift=None) -> torch.Tensor:
    """The (2, C) fp32 sums ``[Σ(x − s), Σ(x − s)²]`` over N, H, W.

    x (N, H, W, C) bf16 or fp32, NHWC, contiguous; shift (C,) fp32, or None
    for s = 0. Calls the op ``mnasnet_tpu_torch::bn_fwd_stats``: a CPU tensor
    takes :func:`bn_fwd_stats_reference`; a CUDA tensor launches the kernel
    once (``bn_fwd_stats.launches`` counts it) or raises. The sums are the
    same from run to run: their order is fixed by the shape, and no float
    atomics.
    """
    _build.refuse_autograd("bn_fwd_stats", x, *_stats_vecs(shift))
    return torch.ops.mnasnet_tpu_torch.bn_fwd_stats.default(x, shift)


bn_fwd_stats.launches = 0


def launch_apply(x, mean, inv, gamma, beta, y, p: ApplyPlan, act: str = "relu") -> torch.Tensor:
    """One launch of the apply kernel of ``act`` with plan ``p`` into ``y``
    (x's shape and dtype, contiguous) on CUDA tensors that the op has
    checked. Counts nothing: the op's CUDA impl counts its launches."""
    dev = x.device
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return launch_apply(x, mean, inv, gamma, beta, y, p, act)
    vecs = _f32((mean, inv, gamma, beta), dev)
    c = x.shape[-1]
    err = getattr(_lib(), _ENTRIES["apply"][act])(
        x.data_ptr(), *(v.data_ptr() for v in vecs), y.data_ptr(), x.numel() // c, c,
        p.vec_bytes, p.threads, p.tg, p.slabs, int(x.dtype == torch.bfloat16), _stream(dev))
    _build.check(err, _ENTRIES["apply"][act])
    return y


def _apply_cuda(x, mean, inv, gamma, beta, act="relu"):
    """The apply op's CUDA impl: the checks, the plan, one counted launch."""
    _check("bn_relu_apply", x, None, (mean, inv, gamma, beta), act)
    if x.device.type != "cuda":
        raise ValueError(f"the apply kernel takes x on the card, not on {x.device}")
    c = x.shape[-1]
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    p = apply_plan(x.numel() // c, c, x.element_size(), alignment(x.data_ptr(), y.data_ptr()))
    launch_apply(x, mean, inv, gamma, beta, y, p, act)
    _count(bn_relu_apply, act)
    return y


def _apply_cpu(x, mean, inv, gamma, beta, act="relu"):
    _check("bn_relu_apply", x, None, (mean, inv, gamma, beta), act)
    return bn_relu_apply_reference(x, mean, inv, gamma, beta, act).contiguous()


def _apply_fake(x, mean, inv, gamma, beta, act="relu"):
    _check("bn_relu_apply", x, None, (mean, inv, gamma, beta), act)
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def _apply(x, mean, inv, gamma, beta, act: str = "relu") -> torch.Tensor:
    """The op ``mnasnet_tpu_torch::bn_relu_apply``."""
    return torch.ops.mnasnet_tpu_torch.bn_relu_apply.default(x, mean, inv, gamma, beta, act)


def bn_relu_apply(x, mean, inv, gamma, beta, act: str = "relu") -> torch.Tensor:
    """y = relu(x·a + b) in x's dtype, a = γ·inv and b = β − μ·a rounded to
    it as the backward's mask rounds them, so ``y > 0`` is that mask; with
    ``act="silu"`` y = silu(x·a + b), z = x·a + b rounded the same way (the
    op keeps its first activation's name).

    x (N, H, W, C) bf16 or fp32, NHWC, contiguous; mean, inv = rsqrt(var +
    eps), gamma, beta (C,) fp32. Calls the op
    ``mnasnet_tpu_torch::bn_relu_apply``: a CPU tensor takes
    :func:`bn_relu_apply_reference`; a CUDA tensor launches the kernel once
    (``bn_relu_apply.launches`` counts it) or raises.
    """
    _build.refuse_autograd("bn_relu_apply", x, mean, inv, gamma, beta)
    return _apply(x, mean, inv, gamma, beta, act)


bn_relu_apply.launches = 0
bn_relu_apply.launches_by_act = dict.fromkeys(ACTS, 0)

_LIB.define("bn_fwd_stats(Tensor x, Tensor? shift) -> Tensor",
            tags=(torch.Tag.needs_exact_strides,))
_LIB.define("bn_relu_apply(Tensor x, Tensor mean, Tensor inv, Tensor gamma, Tensor beta, "
            "str act=\"relu\") -> Tensor", tags=(torch.Tag.needs_exact_strides,))
_LIB.impl("bn_fwd_stats", _stats_cpu, "CPU")
_LIB.impl("bn_fwd_stats", _stats_cuda, "CUDA")
_LIB.impl("bn_relu_apply", _apply_cpu, "CPU")
_LIB.impl("bn_relu_apply", _apply_cuda, "CUDA")
torch.library.register_fake("mnasnet_tpu_torch::bn_fwd_stats", _stats_fake, lib=_LIB)
torch.library.register_fake("mnasnet_tpu_torch::bn_relu_apply", _apply_fake, lib=_LIB)


def region_moments(x: torch.Tensor, stats: str, replicas: Replicas | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`batch_moments` of a BN+ReLU region's forward, from the sums of
    ``mnasnet_tpu_torch::bn_fwd_stats``: the same expectations, the same
    collectives over ``replicas`` (``one_pass``: the (2, C) ``[Σx, Σx²]`` in
    one; ``two_pass``: Σx, then Σ(x − μ)², one each) and, on the CPU, the
    same bits. ``two_pass`` launches the kernel twice. An empty band of a
    spatial mesh (a plane of fewer rows than ranks) launches nothing and adds
    zeros to the sums."""
    if stats not in STATS:
        raise ValueError(f"unknown BN stats {stats!r}; choices: {STATS}")
    c = x.shape[-1]
    n = x.numel() // c
    if replicas is not None:
        n = global_rows(n, replicas)

    def sums(shift=None):
        if x.numel() == 0:
            return x.new_zeros((2, c), dtype=torch.promote_types(x.dtype, torch.float32))
        return torch.ops.mnasnet_tpu_torch.bn_fwd_stats.default(x, shift)

    if stats == "one_pass":
        s = all_reduce_sum(sums(), replicas) / n
        mean = s[0]
        return mean, torch.clamp_min(s[1] - mean.square(), 0.0)
    mean = all_reduce_sum(sums()[0], replicas) / n
    return mean, all_reduce_sum(sums(mean)[1], replicas) / n


def _fwd_region(x, gamma, beta, eps: float, stats: str, replicas: Replicas | None = None,
                act: str = "relu"):
    """The region's forward on the ops (:func:`region_moments`, then
    ``mnasnet_tpu_torch::bn_relu_apply``): (y, mean, var), the values of
    :func:`_fwd_math` (for ReLU), on the CPU the same bits."""
    mean, var = region_moments(x, stats, replicas)
    if x.numel() == 0:
        return torch.empty_like(x), mean, var
    inv = torch.rsqrt(var + eps)  # as bn_bwd recomputes it
    y = _apply(x, mean, inv, gamma, beta, act)
    return y, mean, var


def bn_bwd(x, dy, mean, var, gamma, beta, eps: float, replicas: Replicas | None = None,
           act: str = "relu"):
    """(dx, dγ, dβ) of y = relu((x − mean)·rsqrt(var + eps)·γ + β) (or
    ``silu``), mean and var the batch statistics of x (``_bn_bwd_pallas``,
    ``bn_bwd.py:129``).

    With ``replicas`` (sync-BN: mean and var are the global batch's) the
    reduce's (2, C) output is summed over the replicas in place, one
    collective, before the dx kernel runs with those global sums and the
    global count. The dγ and dβ returned are this replica's own sums, the
    gradient of its share of the loss, as for any other parameter: the step
    sums the gradients over the replicas. The three run from autograd's
    device thread; a capture of the step records them in this order."""
    inv = torch.rsqrt(var + eps)  # the forward's own rsqrt(var + eps)
    dy = dy.to(x.dtype).contiguous()
    # An empty band of a spatial mesh (a plane of fewer rows than ranks)
    # launches nothing and adds zeros to the sums.
    empty = x.numel() == 0
    sums = x.new_zeros((2, x.shape[-1]), dtype=torch.float32) if empty \
        else _reduce(x, dy, mean, inv, gamma, beta, act)
    own, n = sums, x.numel() // x.shape[-1]
    if replicas is not None:
        own = sums.clone()
        all_reduce_sum_([sums], replicas, "all_reduce (BN backward sums)")
        n = global_rows(n, replicas)
    dg, db = sums.unbind()
    dx = torch.empty_like(x) if empty else _dx(x, dy, mean, inv, gamma, beta, dg, db, n, act)
    dg, db = own.unbind()
    return dx, dg.to(gamma.dtype), db.to(beta.dtype)


class _BNReluTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps, stats, replicas, act):
        x = x.contiguous()
        y, mean, var = _fwd_region(x, gamma, beta, eps, stats, replicas, act)
        ctx.save_for_backward(x, gamma, beta, mean, var)
        ctx.eps = eps
        ctx.replicas = replicas
        ctx.act = act
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, gamma, beta, mean, var = ctx.saved_tensors
        dx, dgamma, dbeta = bn_bwd(x, dy, mean, var, gamma, beta, ctx.eps, ctx.replicas,
                                   act=ctx.act)
        return dx, dgamma, dbeta, None, None, None, None


def bn_relu_train(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  eps: float = 1e-5, stats: str = "one_pass",
                  replicas: Replicas | None = None, act: str = "relu"):
    """Training-mode BN (batch statistics) + ReLU (or SiLU, ``act``) with
    the region forward and backward on the kernels.

    x (N, H, W, C) NHWC in the compute dtype; gamma, beta (C,) fp32. Returns
    (y, mean, biased_var); the caller applies the EMA and Bessel's correction
    to the statistics (``models/layers.py``, ``BatchNorm.relu_train_region``).
    ``replicas``: sync-BN over them (:func:`region_moments`, :func:`bn_bwd`).
    """
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}; choices: {ACTS}")
    return _BNReluTrain.apply(x, gamma, beta, eps, stats, replicas, act)
