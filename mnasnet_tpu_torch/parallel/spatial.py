"""Spatial partitioning: each image's rows split into bands over the ranks of
a spatial group, with the halo rows of every k > 1 conv exchanged between
them.

The reference shards H over its mesh's ``spatial`` axis and GSPMD inserts
the halo exchanges (``mnasnet_tpu/parallel/mesh.py:11-13,97-101``). Here the
band plan is explicit and static per shape:

  * :func:`bands`: rank i of a spatial group of S holds rows
    ``[ceil(i·H/S), ceil((i+1)·H/S))`` of a plane of H rows, at every plane
    the model meets (224 px over 2 ranks: 112/112 image rows ... 4/3 rows of
    the 7-row plane). Below S rows a band may be empty;
  * :func:`conv_windows`: for a k x k conv of stride s from a plane of H
    rows, each rank computes the output rows of its band of the output
    plane, ``[c, d)``. It runs the conv, with its own zero padding of k//2,
    on the input rows ``[lo, hi)``: from ``c·s − s·ceil(p/s)`` (the start
    keeps the parity of ``c·s``, so the conv's outputs fall on the wanted
    rows at stride 2) to ``(d−1)·s + p + 1``, clipped to the plane, so that
    the conv's own padding is the plane's edge and nothing else. It keeps
    ``count = d − c`` of the conv's outputs from ``first``. A band shorter
    than the halo takes its rows from as many ranks as hold them;
  * :func:`halo_rows`: the rows ``[lo, hi)`` outside a rank's own band come
    from the ranks that hold them, by one all-reduce within the spatial
    group of a zeroed buffer in which each rank writes the rows it holds
    into every other rank's slot (the pattern of ``parallel/dist.py:
    gather_int``). The buffer is summed as integer words: each word is
    written by one rank and is zero on all others, so the sum is its bits,
    in any dtype. ``all_reduce`` runs over gloo on the CPU, gloo on a CUDA
    tensor and NCCL inside a CUDA graph alike. The backward is the adjoint:
    each rank writes the gradient of its halo rows into its own slot, one
    all-reduce, and each owner adds the slots' rows it holds into the
    gradient of its band.

:func:`banded` runs any conv of the model (the dw kernel, its training op,
the fused MBConv block, the stem) on a rank's band this way; the pooled
features are the bands' sums, summed over the spatial group
(:func:`spatial_mean`). Every exchange is routed through
``parallel/dist.py:_issue``: counted, bounded, watched.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import torch
import torch.distributed as dist

from mnasnet_tpu_torch.parallel.dist import Replicas, _issue, all_reduce_sum


def out_size(n: int, k: int, stride: int) -> int:
    """Output rows of a k x k conv of ``stride`` with zero padding k//2."""
    return (n + 2 * (k // 2) - k) // stride + 1


@functools.lru_cache(maxsize=None)
def bands(rows: int, parts: int) -> tuple[tuple[int, int], ...]:
    """[start, stop) of each of ``parts`` bands of a plane of ``rows`` rows."""
    starts = [-(-i * rows // parts) for i in range(parts + 1)]
    return tuple(zip(starts[:-1], starts[1:]))


class Window(NamedTuple):
    """A rank's input rows [lo, hi) of a conv, and which of the conv's
    outputs on them it keeps: ``count`` rows from ``first``."""

    lo: int
    hi: int
    first: int
    count: int


@functools.lru_cache(maxsize=None)
def conv_windows(rows: int, parts: int, k: int, stride: int) -> tuple[Window, ...]:
    """Each band's :class:`Window` for a k x k conv of ``stride`` (padding
    k//2) from a plane of ``rows`` rows (module docstring)."""
    p = k // 2
    out = []
    for c, d in bands(out_size(rows, k, stride), parts):
        if d == c:
            out.append(Window(0, 0, 0, 0))
            continue
        lo = max(c * stride - stride * -(-p // stride), 0)
        hi = min((d - 1) * stride + p + 1, rows)
        out.append(Window(lo, hi, (c * stride - lo) // stride, d - c))
    return tuple(out)


class Exchange(NamedTuple):
    """One rank's part of a halo exchange: the buffer's rows in all
    (``total``: 0 when no rank needs a row it does not hold), this rank's
    slot for the foreign rows above and below its band (``top``, ``bottom``:
    [start, stop) in the buffer), its own rows of the window ([start, stop)
    in its band) and the rows it sends: ``(start, stop)`` in its band to
    buffer row ``at``."""

    total: int
    top: tuple[int, int]
    own: tuple[int, int]
    bottom: tuple[int, int]
    sends: tuple[tuple[int, int, int], ...]


@functools.lru_cache(maxsize=None)
def exchange(rows: int, windows: tuple[Window, ...], index: int) -> Exchange:
    """Rank ``index``'s :class:`Exchange` when every rank j of the group needs
    the rows ``[windows[j].lo, windows[j].hi)`` of a plane of ``rows`` rows."""
    spans = bands(rows, len(windows))
    slots, at = [], 0
    for (lo, hi, _, _), (a, b) in zip(windows, spans):
        top = (lo, min(hi, a)) if lo < min(hi, a) else None
        bottom = (max(lo, b), hi) if max(lo, b) < hi else None
        mine = []
        for piece in (top, bottom):
            if piece is None:
                mine.append(None)
            else:
                mine.append((piece[0], piece[1], at))
                at += piece[1] - piece[0]
        slots.append(mine)
    a, b = spans[index]
    lo, hi = windows[index].lo, windows[index].hi
    sends = []
    for j, mine in enumerate(slots):
        if j == index:
            continue
        for piece in mine:
            if piece is None:
                continue
            t0, t1 = max(piece[0], a), min(piece[1], b)
            if t0 < t1:
                sends.append((t0 - a, t1 - a, piece[2] + t0 - piece[0]))

    def slot(piece):
        return (0, 0) if piece is None else (piece[2], piece[2] + piece[1] - piece[0])

    own = (max(lo, a) - a, max(min(hi, b) - a, max(lo, a) - a))
    return Exchange(at, slot(slots[index][0]), own, slot(slots[index][1]), tuple(sends))


def _words(buf: torch.Tensor) -> torch.Tensor:
    """``buf`` (contiguous) as the integer words that the all-reduce sums."""
    flat = buf.view(-1)
    return flat.view(torch.int32) if flat.numel() * flat.element_size() % 4 == 0 \
        else flat.view(torch.uint8)


def _sum_in_group(buf: torch.Tensor, replicas: Replicas, what: str) -> None:
    _issue(replicas, what, dist.all_reduce, _words(buf), group=replicas.spatial_group)


def _gather(x: torch.Tensor, ex: Exchange, replicas: Replicas) -> torch.Tensor:
    own = x[:, ex.own[0]:ex.own[1]]
    if not ex.total:
        return own.contiguous()
    n, _, w, c = x.shape
    buf = x.new_zeros((n, ex.total, w, c))
    for s0, s1, at in ex.sends:
        buf[:, at:at + s1 - s0] = x[:, s0:s1]
    _sum_in_group(buf, replicas, "all_reduce (halo rows)")
    return torch.cat([buf[:, ex.top[0]:ex.top[1]], own, buf[:, ex.bottom[0]:ex.bottom[1]]],
                     dim=1)


def _scatter(g: torch.Tensor, ex: Exchange, replicas: Replicas, shape) -> torch.Tensor:
    top = ex.top[1] - ex.top[0]
    own = ex.own[1] - ex.own[0]
    dx = g.new_zeros(shape)
    dx[:, ex.own[0]:ex.own[1]] = g[:, top:top + own]
    if ex.total:
        n, _, w, c = shape
        buf = g.new_zeros((n, ex.total, w, c))
        buf[:, ex.top[0]:ex.top[1]] = g[:, :top]
        buf[:, ex.bottom[0]:ex.bottom[1]] = g[:, top + own:]
        _sum_in_group(buf, replicas, "all_reduce (halo gradients)")
        for s0, s1, at in ex.sends:
            dx[:, s0:s1] += buf[:, at:at + s1 - s0]
    return dx


class _HaloRows(torch.autograd.Function):
    """NHWC band -> the window's rows; backward: the adjoint (module
    docstring)."""

    @staticmethod
    def forward(ctx, x, ex, replicas):
        ctx.ex, ctx.replicas, ctx.shape = ex, replicas, x.shape
        return _gather(x, ex, replicas)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g.contiguous(), ctx.ex, ctx.replicas, ctx.shape), None, None


class _ReplayedHalo(torch.autograd.Function):
    """A window a ``SumTape`` recorded (the recompute of a rematerialised
    block): the recorded rows, no collective; the backward is the adjoint."""

    @staticmethod
    def forward(ctx, x, recorded, ex, replicas):
        ctx.ex, ctx.replicas, ctx.shape = ex, replicas, x.shape
        return recorded.clone()

    @staticmethod
    def backward(ctx, g):
        return _scatter(g.contiguous(), ctx.ex, ctx.replicas, ctx.shape), None, None, None


def spatial_index(replicas: Replicas) -> int:
    return replicas.mesh.spatial_index(replicas.rank)


def halo_rows(x: torch.Tensor, replicas: Replicas, rows: int,
              windows: tuple[Window, ...]) -> torch.Tensor:
    """Rows ``[lo, hi)`` of this rank's window of a plane of ``rows`` rows,
    from its NHWC band ``x`` and the other ranks' (one all-reduce in the
    spatial group unless every window lies in its own band). Inside
    ``parallel.taped_sums`` the window is recorded, or replayed."""
    ex = exchange(rows, windows, spatial_index(replicas))
    x = x.contiguous()
    tape = replicas.tape
    if tape is not None and tape.replaying:
        return _ReplayedHalo.apply(x, tape.take(), ex, replicas)
    out = _HaloRows.apply(x, ex, replicas)
    if tape is not None:
        tape.sums.append(out.detach())
    return out


def plane_rows(replicas: Replicas, x: torch.Tensor) -> int:
    """The full height of the plane whose band is NHWC ``x``, from the band
    plan the model registered (``parallel/mesh.py:register_planes``)."""
    key = (x.shape[1], x.shape[2])
    try:
        return replicas.spatial_planes[key]
    except KeyError:
        raise RuntimeError(f"spatial partitioning: no plane of the registered band plan has "
                           f"{key[0]} band rows of width {key[1]}") from None


def banded(x: torch.Tensor, replicas: Replicas, k: int, stride: int,
           fn: Callable[[torch.Tensor], torch.Tensor], out_channels: int,
           params: tuple = (), rows: Optional[int] = None) -> torch.Tensor:
    """``fn`` (a k x k conv of ``stride`` with zero padding k//2, NHWC in and
    out) on this rank's band ``x`` of a plane of ``rows`` rows (by default
    the registered plane of ``x``): the output rows of this rank's band of
    the output plane. ``fn`` runs on the window of rows
    (:func:`conv_windows`, :func:`halo_rows`) and its outputs are cropped.
    An empty output band calls nothing, and depends on ``x`` and ``params``
    with zero gradients, so that every rank's backward issues the same
    collectives."""
    rows = plane_rows(replicas, x) if rows is None else rows
    windows = conv_windows(rows, replicas.mesh.spatial, k, stride)
    win = windows[spatial_index(replicas)]
    xw = halo_rows(x, replicas, rows, windows)
    if not win.count:
        # (t * 0).sum(): a gradient that is a tensor of its own, not a view
        # of one element, as the step's all-reduce writes into it.
        zero = sum(((t * 0).sum() for t in (xw, *params)), torch.zeros((), device=x.device))
        n, _, w, _ = x.shape
        return x.new_zeros((n, 0, out_size(w, k, stride), out_channels)) + zero.to(x.dtype)
    y = fn(xw)
    if win.first == 0 and win.count == y.shape[1]:
        return y
    return y[:, win.first:win.first + win.count].contiguous()


def spatial_mean(y: torch.Tensor, replicas: Replicas, rows: int) -> torch.Tensor:
    """The mean over H and W of NCHW ``y``, a band of a plane of ``rows``
    rows: the band's sum (in fp32, or y's dtype if wider), summed over the
    spatial group with a differentiable all-reduce, over rows·W, in y's
    dtype. The backward sums the gradient over the group: each rank's loss
    is its share of the global one (``train/steps.py``), so the band's
    gradient is the whole loss's."""
    acc = torch.promote_types(y.dtype, torch.float32)
    s = all_reduce_sum(y.to(acc).sum(dim=(2, 3)), replicas, group=replicas.spatial_group)
    return (s / (rows * y.shape[3])).to(y.dtype)


def exchanges(rows: int, parts: int, k: int, stride: int) -> int:
    """1 when the conv's windows need rows from another rank (one
    all-reduce each way), else 0."""
    return int(exchange(rows, conv_windows(rows, parts, k, stride), 0).total > 0)
