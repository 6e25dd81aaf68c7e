"""Squeeze-and-excitation on four kernels (``csrc/se.cu``): a pool and a gated
scale for the forward, a gate-gradient reduction and a fused dx pass for the
backward.

EfficientNet's squeeze-and-excitation (``models/layers.py:SqueezeExcitation``)
on NHWC ``x`` (N, H, W, C) with its two 1x1 convs with bias, fc1 (C -> S)
and fc2 (S -> C):

  forward   p = mean_hw x                                    (:func:`se_pool`)
            h = fc1(p), gate = sigmoid(fc2(silu(h)))          (torch ops on (N, C))
            y = x · gate[n, c]                                (:func:`se_scale`)
  backward  dgate = Σ_hw g·x                                  (:func:`se_dgate`)
            the MLP's backward on the (N, S) and (N, C) vectors (torch ops)
            dx = g · gate[n, c] + dp[n, c] / HW               (:func:`se_dx`)

:func:`squeeze_excitation` is that as a ``torch.autograd.Function`` over x and
the four fc parameters. Everything on the (N, C) vectors runs in x's dtype, as
the module's plain forward and its autograd do; the two reductions sum in
fp32, and dx is one rounding of an fp32 sum where autograd rounds g·gate and
the expanded mean's gradient apart and adds them. Saved for the backward: x,
the pooled vector, fc1's output and the gate; nothing plane-sized beyond x.

Each kernel is a ``torch.library`` op (``mnasnet_tpu_torch::se_pool``,
``::se_scale``, ``::se_dgate``, ``::se_dx``) whose CPU impl is its plain
PyTorch version (``*_reference``), whose CUDA impl launches the kernel or
raises, and whose fake impl gives the output's shape; each wrapper's
``launches`` counts the CUDA launches (a CUDA-graph replay launches without
it). :func:`reduce_plan` plans the two ticketed reductions, :func:`map_plan`
the two elementwise passes, from the shape alone.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from mnasnet_tpu_torch.ops.cuda import _build
from mnasnet_tpu_torch.ops.cuda.bn_bwd import _f32, _stream, _vector_bytes, alignment, scratch

_DTYPES = (torch.bfloat16, torch.float32)
# Threads of one block (kThreads in the source), and the blocks a launch aims
# for: eight per SM of an H100 (132 SMs).
THREADS = 256
TARGET_BLOCKS = 8 * 132
# Rows each row lane walks at the least, so that a thread's setup is spread
# over some work.
MIN_ROWS_PER_THREAD = 8
# The most vectors of a row one block's tile spans (512 bytes of a row in
# 16-byte vectors), and the most slabs of a reduction, whose finishing block
# reads 4 x slabs x tile-channels bytes.
TILE_MAX = 32
MAX_SLABS = 64


class Plan(NamedTuple):
    """One launch: block (tile, slab, n) of ``threads`` threads, ``lanes``
    rows side by side of ``tg`` vectors of ``vec`` channels, walks
    ``rows_per_slab`` of sample n's HW rows. A reduction's partial sums take
    ``partial_floats`` fp32 and its tickets ``tickets`` int32 (none when it
    has one slab)."""
    vec: int
    vec_bytes: int
    threads: int
    tg: int
    tiles: int
    lanes: int
    slabs: int
    rows_per_slab: int
    partial_floats: int
    tickets: int


def _slabs(n: int, hw: int, tiles: int, lanes: int, most: int) -> tuple[int, int]:
    """(slabs, rows_per_slab): slabs fill the card to ``TARGET_BLOCKS`` over
    the n samples unless a lane would walk fewer than ``MIN_ROWS_PER_THREAD``
    rows, at most ``most``; slabs left empty are dropped."""
    slabs = max(1, min(-(-TARGET_BLOCKS // (tiles * n)), -(-hw // (lanes * MIN_ROWS_PER_THREAD)),
                       most))
    rows = -(-hw // slabs)
    return -(-hw // rows), rows


def _check_shape(n: int, hw: int, c: int, what: str) -> None:
    if n <= 0 or hw <= 0 or c <= 0 or c % 2:
        raise ValueError(f"{what} needs N, H·W > 0 and an even channel count, got {n}, {hw}, {c}")
    if n > 65535:
        raise ValueError(f"{what} takes at most 65535 samples, got {n}")


@functools.lru_cache(maxsize=None)
def reduce_plan(n: int, hw: int, c: int, itemsize: int, align: int = 16) -> Plan:
    """The pool's or the gate gradient's launch for ``n`` samples of ``hw``
    rows of ``c`` channels of ``itemsize`` bytes, the inputs aligned to
    ``align`` bytes.

    The vector is the widest of 16, 8 and 4 bytes that holds two elements and
    divides a row and the alignment; tiles split the row's vectors evenly
    into runs of at most ``TILE_MAX``; the slabs as :func:`_slabs`, at most
    ``MAX_SLABS``."""
    _check_shape(n, hw, c, "the SE reduction")
    vec_bytes = _vector_bytes(c, itemsize, align, "the SE reduction's inputs")
    vec = vec_bytes // itemsize
    groups = c // vec
    tiles = -(-groups // TILE_MAX)
    tg = -(-groups // tiles)
    lanes = THREADS // tg
    slabs, rows = _slabs(n, hw, tiles, lanes, MAX_SLABS)
    partial, tickets = (n * tiles * slabs * tg * vec, n * tiles) if slabs > 1 else (0, 0)
    return Plan(vec, vec_bytes, THREADS, tg, tiles, lanes, slabs, rows, partial, tickets)


@functools.lru_cache(maxsize=None)
def map_plan(n: int, hw: int, c: int, itemsize: int, align: int = 16) -> Plan:
    """The scale's or the dx pass's launch, as :func:`reduce_plan` lays it
    out: a tile is the widest divisor of the row's vectors, at most
    ``TILE_MAX``, that leaves at most a sixteenth of a block's threads idle
    (``bn_bwd.apply_plan``'s rule), so every tile is whole."""
    _check_shape(n, hw, c, "the SE pass")
    vec_bytes = _vector_bytes(c, itemsize, align, "the SE pass's input and output")
    vec = vec_bytes // itemsize
    groups = c // vec
    tg = max(t for t in range(1, min(groups, TILE_MAX) + 1)
             if groups % t == 0 and 16 * (THREADS // t * t) >= 15 * THREADS)
    tiles, lanes = groups // tg, THREADS // tg
    slabs, rows = _slabs(n, hw, tiles, lanes, 65535)
    return Plan(vec, vec_bytes, THREADS, tg, tiles, lanes, slabs, rows, 0, 0)


_LAUNCH = [ctypes.c_int, ctypes.c_longlong] + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_PROTOTYPES = {
    "se_pool": ([ctypes.c_void_p] * 4 + _LAUNCH, ctypes.c_int),
    "se_dgate": ([ctypes.c_void_p] * 5 + _LAUNCH, ctypes.c_int),
    "se_scale": ([ctypes.c_void_p] * 3 + _LAUNCH, ctypes.c_int),
    "se_dx": ([ctypes.c_void_p] * 4 + _LAUNCH, ctypes.c_int),
}


def _lib() -> ctypes.CDLL:
    return _build.load("se", _PROTOTYPES)


def _launch(entry: str, planes, vecs, scratch_of, out, p: Plan) -> None:
    """One launch of C entry ``entry`` with plan ``p``: ``planes`` the
    (N, H, W, C) inputs, ``vecs`` the fp32 (N, C) vectors, ``out`` the
    output; ``scratch_of`` True for a reduction."""
    x = planes[0]
    dev = x.device
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return _launch(entry, planes, vecs, scratch_of, out, p)
    n, h, w, c = x.shape
    stream = _stream(dev)
    extra = []
    if scratch_of:
        if p.slabs > 1:
            partial, tickets = scratch(dev, stream, p.partial_floats, p.tickets)
            extra = [partial.data_ptr(), tickets.data_ptr()]
        else:
            extra = [None, None]
    err = getattr(_lib(), entry)(
        *(t.data_ptr() for t in planes), *(v.data_ptr() for v in vecs), *extra, out.data_ptr(),
        n, h * w, c, p.vec_bytes, p.threads, p.tg, p.slabs, int(x.dtype == torch.bfloat16),
        stream)
    _build.check(err, entry)


def _check(what, planes, vecs):
    """The checks every impl of an op runs (an artifact or a compiled graph
    calls the op directly): NHWC planes of one shape on one device, (N, C)
    vectors there; on the card bf16 or fp32 planes of one dtype, contiguous,
    with an even channel count."""
    x = planes[0]
    if x.dim() != 4:
        raise ValueError(f"{what} takes NHWC planes, got shape {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda, not {x.device}")
    n, c = x.shape[0], x.shape[-1]
    for t in planes[1:]:
        if t.shape != x.shape or t.device != x.device:
            raise ValueError(f"{what}: the planes must share shape {tuple(x.shape)} and device "
                             f"{x.device}, got {tuple(t.shape)} on {t.device}")
    for v in vecs:
        if v.shape != (n, c) or v.device != x.device:
            raise ValueError(f"{what}: the vectors must be ({n}, {c}) on {x.device}, got "
                             f"{tuple(v.shape)} on {v.device}")
    if x.device.type == "cuda":
        if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in planes):
            raise TypeError(f"{what} takes its planes in bf16 or fp32, one dtype, not "
                            f"{[t.dtype for t in planes]}")
        if not all(t.is_contiguous() for t in planes):
            raise ValueError(f"{what} takes contiguous NHWC planes")
        if c % 2:
            raise ValueError(f"{what} needs an even channel count, got {c}")


def _on_card(what, x) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"the {what} kernel takes its planes on the card, not on {x.device}")


# ---------------------------------------------------------------- the plain versions


def se_pool_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the pool: the mean over H and W, (N, C) in
    x's dtype (torch's mean: fp32 sums, rounded once)."""
    return x.mean(dim=(1, 2))


def se_scale_reference(x: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the scale: x · gate[n, c] in x's dtype."""
    return (x * gate.to(x.dtype)[:, None, None, :]).contiguous()


def se_dgate_reference(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the gate gradient: Σ_hw g·x in fp32 (float64
    stays float64), (N, C)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    return (g.to(acc) * x.to(acc)).sum(dim=(1, 2))


def se_dx_reference(g: torch.Tensor, gate: torch.Tensor, dpool: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the dx pass: g · gate[n, c] + dpool[n, c] /
    HW in fp32 (float64 stays float64), rounded once to g's dtype."""
    acc = torch.promote_types(g.dtype, torch.float32)
    hw = g.shape[1] * g.shape[2]
    dx = g.to(acc) * gate.to(acc)[:, None, None, :] + (dpool.to(acc) / hw)[:, None, None, :]
    return dx.to(g.dtype).contiguous()


# ---------------------------------------------------------------- the ops


def _pool_cuda(x):
    _check("se_pool", (x,), ())
    _on_card("se_pool", x)
    n, h, w, c = x.shape
    p = reduce_plan(n, h * w, c, x.element_size(), alignment(x.data_ptr()))
    out = x.new_empty((n, c))
    _launch("se_pool", (x,), (), True, out, p)
    se_pool.launches += 1
    return out


def _pool_cpu(x):
    _check("se_pool", (x,), ())
    return se_pool_reference(x)


def _pool_fake(x):
    _check("se_pool", (x,), ())
    return x.new_empty((x.shape[0], x.shape[-1]))


def _scale_cuda(x, gate):
    _check("se_scale", (x,), (gate,))
    _on_card("se_scale", x)
    n, h, w, c = x.shape
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    p = map_plan(n, h * w, c, x.element_size(), alignment(x.data_ptr(), y.data_ptr()))
    _launch("se_scale", (x,), _f32((gate,), x.device), False, y, p)
    se_scale.launches += 1
    return y


def _scale_cpu(x, gate):
    _check("se_scale", (x,), (gate,))
    return se_scale_reference(x, gate)


def _scale_fake(x, gate):
    _check("se_scale", (x,), (gate,))
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def _dgate_cuda(g, x):
    _check("se_dgate", (g, x), ())
    _on_card("se_dgate", x)
    n, h, w, c = x.shape
    p = reduce_plan(n, h * w, c, x.element_size(), alignment(g.data_ptr(), x.data_ptr()))
    out = x.new_empty((n, c), dtype=torch.float32)
    _launch("se_dgate", (g, x), (), True, out, p)
    se_dgate.launches += 1
    return out


def _dgate_cpu(g, x):
    _check("se_dgate", (g, x), ())
    return se_dgate_reference(g, x)


def _dgate_fake(g, x):
    _check("se_dgate", (g, x), ())
    return x.new_empty((x.shape[0], x.shape[-1]),
                       dtype=torch.promote_types(x.dtype, torch.float32))


def _dx_cuda(g, gate, dpool):
    _check("se_dx", (g,), (gate, dpool))
    _on_card("se_dx", g)
    n, h, w, c = g.shape
    dx = torch.empty_like(g, memory_format=torch.contiguous_format)
    p = map_plan(n, h * w, c, g.element_size(), alignment(g.data_ptr(), dx.data_ptr()))
    _launch("se_dx", (g,), _f32((gate, dpool), g.device), False, dx, p)
    se_dx.launches += 1
    return dx


def _dx_cpu(g, gate, dpool):
    _check("se_dx", (g,), (gate, dpool))
    return se_dx_reference(g, gate, dpool)


def _dx_fake(g, gate, dpool):
    _check("se_dx", (g,), (gate, dpool))
    return torch.empty_like(g, memory_format=torch.contiguous_format)


# ``needs_exact_strides``: a compiler hands the planes over with the strides
# they have in eager mode (contiguous NHWC), never re-laid out.
_LIB = torch.library.Library("mnasnet_tpu_torch", "FRAGMENT")
for _name, _schema, _impls in (
        ("se_pool", "se_pool(Tensor x) -> Tensor", (_pool_cpu, _pool_cuda, _pool_fake)),
        ("se_scale", "se_scale(Tensor x, Tensor gate) -> Tensor",
         (_scale_cpu, _scale_cuda, _scale_fake)),
        ("se_dgate", "se_dgate(Tensor g, Tensor x) -> Tensor",
         (_dgate_cpu, _dgate_cuda, _dgate_fake)),
        ("se_dx", "se_dx(Tensor g, Tensor gate, Tensor dpool) -> Tensor",
         (_dx_cpu, _dx_cuda, _dx_fake))):
    _LIB.define(_schema, tags=(torch.Tag.needs_exact_strides,))
    _LIB.impl(_name, _impls[0], "CPU")
    _LIB.impl(_name, _impls[1], "CUDA")
    torch.library.register_fake(f"mnasnet_tpu_torch::{_name}", _impls[2], lib=_LIB)

_OPS = torch.ops.mnasnet_tpu_torch


def se_pool(x: torch.Tensor) -> torch.Tensor:
    """The mean over H and W of NHWC ``x`` (N, H, W, C), (N, C) in x's dtype:
    fp32 sums, rounded once. Calls the op ``mnasnet_tpu_torch::se_pool``: a
    CPU tensor takes :func:`se_pool_reference`; a CUDA tensor (bf16 or fp32,
    contiguous, C even) launches the kernel once (``se_pool.launches``) or
    raises. The sums are the same from run to run: their order is fixed by
    the shape, and no float atomics."""
    _build.refuse_autograd("se_pool", x)
    return _OPS.se_pool.default(x)


def se_scale(x: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """y = x · gate[n, c] in x's dtype, one rounding; ``gate`` (N, C).
    Calls the op ``mnasnet_tpu_torch::se_scale`` (:func:`se_scale_reference`
    on the CPU; on the card one launch, ``se_scale.launches``, or raises)."""
    _build.refuse_autograd("se_scale", x, gate)
    return _OPS.se_scale.default(x, gate)


def se_dgate(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Σ_hw g·x, (N, C) fp32, for g and x of one NHWC shape and dtype.
    Calls the op ``mnasnet_tpu_torch::se_dgate`` (:func:`se_dgate_reference`
    on the CPU; on the card one launch, ``se_dgate.launches``, or raises),
    the same bits from run to run."""
    _build.refuse_autograd("se_dgate", g, x)
    return _OPS.se_dgate.default(g, x)


def se_dx(g: torch.Tensor, gate: torch.Tensor, dpool: torch.Tensor) -> torch.Tensor:
    """dx = g · gate[n, c] + dpool[n, c] / HW, summed in fp32 and rounded
    once to g's dtype; ``gate`` and ``dpool`` (N, C). Calls the op
    ``mnasnet_tpu_torch::se_dx`` (:func:`se_dx_reference` on the CPU; on the
    card one launch, ``se_dx.launches``, or raises)."""
    _build.refuse_autograd("se_dx", g, gate, dpool)
    return _OPS.se_dx.default(g, gate, dpool)


se_pool.launches = 0
se_scale.launches = 0
se_dgate.launches = 0
se_dx.launches = 0


# ---------------------------------------------------------------- the module's math


def _matrix(w: torch.Tensor, dtype) -> torch.Tensor:
    """A 1x1 conv's (Cout, Cin, 1, 1) weight as the (Cout, Cin) matrix in
    ``dtype``."""
    return w[:, :, 0, 0].to(dtype)


def _excite(p, w1, b1, w2, b2) -> tuple[torch.Tensor, torch.Tensor]:
    """(fc1's output h, the gate sigmoid(fc2(silu(h)))) of the pooled (N, C)
    ``p``, in p's dtype, as ``layers.BiasedPointwiseConv`` computes them."""
    h = F.linear(p, _matrix(w1, p.dtype), b1.to(p.dtype))
    return h, torch.sigmoid(F.linear(F.silu(h), _matrix(w2, p.dtype), b2.to(p.dtype)))


def _forward(x, w1, b1, w2, b2):
    p = _OPS.se_pool.default(x)
    h, gate = _excite(p, w1, b1, w2, b2)
    return _OPS.se_scale.default(x, gate), p, h, gate


class _SqueezeExcitation(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        x = x.contiguous()
        y, p, h, gate = _forward(x, w1, b1, w2, b2)
        ctx.save_for_backward(x, p, h, gate, w1, w2)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, p, h, gate, w1, w2 = ctx.saved_tensors
        dt = x.dtype
        g = dy.to(dt).contiguous()
        # The gate's gradient rounded to x's dtype, as autograd's sum of the
        # broadcast multiply's gradient is; then the MLP's backward, the
        # operations autograd runs for it.
        dz = torch.ops.aten.sigmoid_backward(_OPS.se_dgate.default(g, x).to(dt), gate)
        dh = torch.ops.aten.silu_backward(dz @ _matrix(w2, dt), h)
        dx = _OPS.se_dx.default(g, gate, dh @ _matrix(w1, dt))
        dw2 = (dz.t() @ F.silu(h)).to(w2.dtype).view_as(w2)
        dw1 = (dh.t() @ p).to(w1.dtype).view_as(w1)
        return dx, dw1, dh.sum(0).to(w1.dtype), dw2, dz.sum(0).to(w2.dtype)


def squeeze_excitation(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                       b2: torch.Tensor) -> torch.Tensor:
    """The squeeze-and-excitation of NHWC ``x`` (N, H, W, C) on the SE ops:
    the pool, fc1 (``w1`` (S, C, 1, 1), ``b1`` (S,)), SiLU, fc2 (``w2`` (C,
    S, 1, 1), ``b2`` (C,)), sigmoid, the scale; y contiguous NHWC in x's
    dtype. Differentiable in x and the four parameters
    (:class:`_SqueezeExcitation`) where autograd records; otherwise the ops
    alone, which an export records as they are."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w1, b1, w2, b2)):
        return _SqueezeExcitation.apply(x, w1, b1, w2, b2)
    return _forward(x.contiguous(), w1, b1, w2, b2)[0]
