"""The whole inference MBConv block in one kernel (``csrc/mbconv.cu``).

Replaces the Pallas kernel ``_mbconv_kernel`` of
``mnasnet_tpu/ops/pallas/mbconv.py`` (reached through ``mbconv_fused``)::

    pw-expand -> BN -> ReLU -> dw k x k -> BN -> ReLU -> pw-project -> BN [+ x]

with the BNs folded and the expanded tensor kept on chip: the kernel reads x
once and writes y once. The TPU kernel holds a whole expanded plane per sample
in VMEM; a Hopper block has 227 KB of shared memory, so the CUDA kernel tiles
the output and expands each tile's input halo chunk by chunk of the expanded
channels (see the source note in ``csrc/mbconv.cu``). :func:`plan` picks the
tile, and :func:`mbconv_fits_smem` (the counterpart of ``mbconv_fits_vmem``)
says whether a block has a plan at all.

The kernel is the ``torch.library`` op ``mnasnet_tpu_torch::mbconv_block``
(CPU impl :func:`mbconv_reference`, CUDA impl the kernel, a fake impl for
tracing), so that an export or a compile records the op itself; a tensor on
any other device finds no impl and raises, and nothing falls back from one
impl to another. Each impl checks its arguments; :func:`mbconv_fused` calls the op.
The block is inference-only: where autograd would record it, it raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from mnasnet_tpu_torch.ops.cuda import _build

# Shared memory one block of an H100 may use (232,448 bytes of the SM's 228 KB).
SMEM_LIMIT = 232_448
# Threads of one block, and the candidates of the planner: output-tile edges
# and expanded-channel chunk widths (fp32 kernel; the bf16 kernel takes any
# multiple of 16 up to 128, ``_TC_CHUNKS``).
THREADS = 512
_TILE_EDGES = (14, 7, 8, 4, 16)
_CHUNKS = (16, 32, 64, 128)
_TC_CHUNKS = tuple(range(16, 129, 16))
# Project items (16 output pixels x 32 output channels) one warp of the bf16
# kernel keeps in registers (``kItemsPerWarp`` in csrc/mbconv.cu).
ITEMS_PER_WARP = 4
# The bf16 planner's price of one more chunk, in expanded channels (from the
# plan sweep of tools/tune_plans.py on an H100).
CHUNK_COST = 32
_DTYPES = (torch.bfloat16, torch.float32)


class Plan(NamedTuple):
    th: int     # output rows of one block's tile
    tw: int     # output columns of one block's tile
    mc: int     # expanded channels per chunk
    smem: int   # shared-memory bytes of one block
    expand_px: int  # input pixels the grid expands per sample (halo recompute included)
    threads: int  # threads of one block


def out_size(n: int, k: int, stride: int) -> int:
    return (n + 2 * (k // 2) - k) // stride + 1


def _align16(b: int) -> int:
    return (b + 15) // 16 * 16


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def smem_bytes(th: int, tw: int, mc: int, cin: int, cout: int, k: int, stride: int,
               elem_bytes: int) -> int:
    """Shared memory of one block; the same layouts as ``tc_layout`` (bf16,
    ``elem_bytes`` 2) and ``mb_layout`` (fp32) in ``csrc/mbconv.cu``.

    bf16: x halo [halo][Cin16 + 8]; the mid chunk [halo][MC + 8], which the
    output tile [TH*TW][Cout + 8] reuses; the z chunk [TH*TW][MC + 8]; two
    buffers each of the we [Cin16][MC + 8], wp [MC][Cout16 + 8] and wd
    [k*k][MC] chunks (rows 16-byte multiples with a 16-byte skew; K
    dimensions padded to 16). fp32: x halo, mid and z chunks (rows padded by
    2 elements), the fp32 accumulator, fp32 dw weights and four chunk vectors.
    """
    halo = ((th - 1) * stride + k) * ((tw - 1) * stride + k)
    mo = th * tw
    if elem_bytes == 2:
        xs, mcs, wps = tc_row_strides(mc, cin, cout)
        return (_align16(halo * xs * 2)
                + _align16(max(halo * mcs, mo * (cout + 8)) * 2)
                + _align16(mo * mcs * 2)
                + 2 * _align16(_round_up(cin, 16) * mcs * 2)
                + 2 * _align16(mc * wps * 2)
                + 2 * _align16(k * k * mc * 2))
    return (_align16(halo * (cin + 2) * 4)
            + _align16(halo * (mc + 2) * 4)
            + _align16(mo * (mc + 2) * 4)
            + _align16(mo * cout * 4)
            + _align16(k * k * mc * 4)
            + _align16(4 * mc * 4))


def tc_row_strides(mc: int, cin: int, cout: int) -> tuple[int, int, int]:
    """Row strides (elements) of the bf16 kernel's ldmatrix operands: the x
    halo [.][Cin16 + 8], the mid, z and we chunks [.][MC + 8] and the wp
    chunk [.][Cout16 + 8]; K padded to 16, plus a 16-byte skew."""
    return _round_up(cin, 16) + 8, mc + 8, _round_up(cout, 16) + 8


def project_items(th: int, tw: int, cout: int) -> int:
    """Project items of one bf16 block: 16-pixel row tiles x 32-channel groups."""
    return -(-(th * tw) // 16) * -(-cout // 32)


def _expanded_extent(n_in: int, n_out: int, tile: int, k: int, stride: int) -> int:
    """Input rows (or columns) that the tiles of one edge expand, each tile its
    halo clipped to the image."""
    p = k // 2
    total = 0
    for o0 in range(0, n_out, tile):
        t = min(tile, n_out - o0)
        lo = max(0, o0 * stride - p)
        hi = min(n_in, (o0 + t - 1) * stride - p + k)
        total += hi - lo
    return total


def _edges(n_out: int) -> list[int]:
    return [n_out] + [e for e in _TILE_EDGES if e < n_out]


def _chunk(halo_px: int, cmid: int) -> int:
    """fp32: the narrowest chunk whose expand step gives every thread a 4x4
    tile (4 pixels x 4 channels), at most 128 channels and at most Cmid."""
    mc = next((m for m in _CHUNKS if -(-halo_px // 4) * (m // 4) >= THREADS), _CHUNKS[-1])
    return min(mc, cmid)


def feasible(th: int, tw: int, mc: int, cin: int, cmid: int, cout: int, k: int, stride: int,
             elem_bytes: int, threads: int) -> bool:
    """Whether the kernel of ``elem_bytes`` can run this tile plan."""
    if threads % 32 or threads > THREADS:
        return False
    if smem_bytes(th, tw, mc, cin, cout, k, stride, elem_bytes) > SMEM_LIMIT:
        return False
    if elem_bytes == 2:
        return (mc % 16 == 0 and mc <= 128 and mc < cmid + 16
                and project_items(th, tw, cout) <= ITEMS_PER_WARP * threads // 32)
    return mc % 8 == 0 and mc <= cmid


@functools.lru_cache(maxsize=None)
def plan(h: int, w: int, cin: int, cmid: int, cout: int, k: int, stride: int,
         elem_bytes: int = 2) -> Plan | None:
    """The tile plan of one block shape, or None if none fits.

    Tiles have at most 256 output pixels. bf16 (tensor-core kernel; Cin,
    Cmid and Cout multiples of 8): among the (tile, chunk) pairs that fit
    ``SMEM_LIMIT`` and whose project accumulators fit the warps' registers
    (``ITEMS_PER_WARP``), the one with the least expand work (input pixels
    expanded, halo recompute included, times Cmid padded to the chunk), each
    chunk costing ``CHUNK_COST`` channels more; then one whose edges divide
    the output, then the largest, then the widest. The rule comes from timing every plan of
    the 16 blocks of mnasnet1_0@224 at bs128 on an H100
    (``python -m mnasnet_tpu_torch.tools.tune_plans``, PERF.md). fp32: the
    tile that expands the fewest input pixels, then as above; the chunk
    width fills the expand step's threads (:func:`_chunk`), narrowed until
    the plan fits ``SMEM_LIMIT``.
    """
    if k not in (3, 5) or stride not in (1, 2):
        return None
    if elem_bytes == 2 and (cin % 8 or cmid % 8 or cout % 8):
        return None
    if elem_bytes != 2 and (cin % 2 or cmid % 8 or cout % 4):
        return None
    ho, wo = out_size(h, k, stride), out_size(w, k, stride)
    best, best_key = None, None
    for th in _edges(ho):
        for tw in _edges(wo):
            if th * tw > 256:
                continue
            px = (_expanded_extent(h, ho, th, k, stride)
                  * _expanded_extent(w, wo, tw, k, stride))
            ragged = (ho % th != 0) + (wo % tw != 0)
            if elem_bytes == 2:
                for mc in _TC_CHUNKS:
                    if not feasible(th, tw, mc, cin, cmid, cout, k, stride, 2, THREADS):
                        continue
                    smem = smem_bytes(th, tw, mc, cin, cout, k, stride, 2)
                    key = (px * _round_up(cmid, mc) * (mc + CHUNK_COST) / mc, ragged, -th * tw,
                           -tw)
                    if best_key is None or key < best_key:
                        best, best_key = Plan(th, tw, mc, smem, px, THREADS), key
                continue
            halo = min(h, (th - 1) * stride + k) * min(w, (tw - 1) * stride + k)
            mc = _chunk(halo, cmid)
            while mc > 8 and smem_bytes(th, tw, mc, cin, cout, k, stride, elem_bytes) > SMEM_LIMIT:
                mc //= 2
            smem = smem_bytes(th, tw, mc, cin, cout, k, stride, elem_bytes)
            if smem > SMEM_LIMIT:
                continue
            key = (px, ragged, -th * tw)
            if best_key is None or key < best_key:
                best, best_key = Plan(th, tw, mc, smem, px, THREADS), key
    return best


@torch.compiler.assume_constant_result
def mbconv_fits_smem(H: int, W: int, Cin: int, Cmid: int, Cout: int, k: int, stride: int,
                     elem_bytes: int = 2) -> bool:
    """Whether the fused kernel has a shared-memory plan for this block: a
    pure function of static shapes, which a compiler evaluates once while it
    traces (``assume_constant_result``) instead of tracing the planner."""
    return plan(H, W, Cin, Cmid, Cout, k, stride, elem_bytes) is not None


def mbconv_reference(x, we, se, be, wd, sd, bd, wp, sp, bp, *, kernel_size, stride,
                     residual):
    """Plain PyTorch version: the unfused composition of ``mbconv_reference``
    (``mnasnet_tpu/ops/pallas/mbconv.py:214``) at the fused kernel's rounding
    points. Weights are cast to x's dtype; each of expand, depthwise and
    project accumulates in fp32 and applies its affine (and ReLU) in fp32;
    mid and z round once to x's dtype; the residual is added in fp32."""
    k = kernel_size
    cdt = x.dtype
    cmid = we.shape[1]

    def w32(t):
        return t.to(cdt).float()

    mid = torch.relu(torch.matmul(x.float(), w32(we)) * se.float() + be.float()).to(cdt)
    wdw = w32(wd).reshape(k, k, cmid).permute(2, 0, 1).unsqueeze(1)
    z = F.conv2d(mid.permute(0, 3, 1, 2).float(), wdw, stride=stride, padding=k // 2,
                 groups=cmid).permute(0, 2, 3, 1)
    z = torch.relu(z * sd.float() + bd.float()).to(cdt)
    o = torch.matmul(z.float(), w32(wp)) * sp.float() + bp.float()
    if residual:
        o = o + x.float()
    return o.to(cdt).contiguous()


_PROTOTYPES = {
    "mbconv_block": ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 14 + [ctypes.c_void_p],
                     ctypes.c_int),
    "mbconv_smem_bytes": ([ctypes.c_int] * 8, ctypes.c_longlong),
}


def _lib() -> ctypes.CDLL:
    return _build.load("mbconv", _PROTOTYPES)


def _check(x, we, se, be, wd, sd, bd, wp, sp, bp, k, stride, residual):
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC, got shape {tuple(x.shape)}")
    cin = x.shape[-1]
    if we.dim() != 2 or we.shape[0] != cin:
        raise ValueError(f"we must be (Cin={cin}, Cmid), got {tuple(we.shape)}")
    cmid = we.shape[1]
    if wp.dim() != 2 or wp.shape[0] != cmid:
        raise ValueError(f"wp must be (Cmid={cmid}, Cout), got {tuple(wp.shape)}")
    cout = wp.shape[1]
    if wd.numel() != k * k * cmid or wd.shape[0] != k or wd.shape[1] != k:
        raise ValueError(f"wd must be (k, k, 1, Cmid) for k={k}, Cmid={cmid}")
    for name, v, c in (("se", se, cmid), ("be", be, cmid), ("sd", sd, cmid),
                       ("bd", bd, cmid), ("sp", sp, cout), ("bp", bp, cout)):
        if v.shape != (c,):
            raise ValueError(f"{name} must be ({c},), got {tuple(v.shape)}")
    if residual and (stride != 1 or cin != cout):
        raise ValueError("a residual needs stride 1 and Cin == Cout")


def mbconv_fused(x, we, se, be, wd, sd, bd, wp, sp, bp, *, kernel_size: int,
                 stride: int, residual: bool) -> torch.Tensor:
    """Fused inference MBConv block.

    x (N, H, W, Cin) bf16 or fp32, NHWC; we (Cin, Cmid); wd (k, k, 1, Cmid);
    wp (Cmid, Cout); the folded BN pairs (se, be), (sd, bd) (Cmid,) and
    (sp, bp) (Cout,). Returns (N, Ho, Wo, Cout) in x's dtype. Calls the op
    ``mnasnet_tpu_torch::mbconv_block``: a CPU tensor takes
    :func:`mbconv_reference`, a CUDA tensor launches the kernel
    (``mbconv_fused.launches`` counts those launches) or raises.
    """
    args = (x, we, se, be, wd, sd, bd, wp, sp, bp)
    _build.refuse_autograd("mbconv_fused", *args)
    return torch.ops.mnasnet_tpu_torch.mbconv_block.default(*args, kernel_size, stride,
                                                            residual)


def _mbconv_cuda(x, we, se, be, wd, sd, bd, wp, sp, bp, k, stride, residual):
    """The op's CUDA impl: the op's and the kernel's checks, the plan, one
    launch. Every impl checks its arguments: an artifact calls the op
    directly."""
    args = (x, we, se, be, wd, sd, bd, wp, sp, bp)
    _check(*args, k, stride, residual)
    if x.device.type != "cuda":
        raise ValueError(f"the MBConv kernel takes x on the card, not on {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"the MBConv kernel takes bf16 or fp32, not {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be a contiguous NHWC tensor")
    n, h, w, cin = x.shape
    cmid, cout = we.shape[1], wp.shape[1]
    p = plan(h, w, cin, cmid, cout, k, stride, x.element_size())
    if p is None:
        raise ValueError(f"no shared-memory plan for the block {h}x{w} {cin}->{cmid}->{cout} "
                         f"k{k} s{stride}; check mbconv_fits_smem first")
    y = launch(*kernel_args(*args, kernel_size=k), stride=stride, residual=residual, p=p)
    mbconv_fused.launches += 1
    return y


def _mbconv_cpu(x, we, se, be, wd, sd, bd, wp, sp, bp, k, stride, residual):
    _check(x, we, se, be, wd, sd, bd, wp, sp, bp, k, stride, residual)
    return mbconv_reference(x, we, se, be, wd, sd, bd, wp, sp, bp, kernel_size=k,
                            stride=stride, residual=residual)


def _mbconv_fake(x, we, se, be, wd, sd, bd, wp, sp, bp, k, stride, residual):
    _check(x, we, se, be, wd, sd, bd, wp, sp, bp, k, stride, residual)
    n, h, w, _ = x.shape
    return x.new_empty((n, out_size(h, k, stride), out_size(w, k, stride), wp.shape[1]))


def kernel_args(x, we, se, be, wd, sd, bd, wp, sp, bp, *, kernel_size: int) -> tuple:
    """The kernel's operands on x's device: weights in x's dtype (wd as
    (k, k, Cmid)), the six affine vectors fp32, all contiguous."""
    dev, cdt = x.device, x.dtype
    k, cmid = kernel_size, we.shape[1]
    se_, be_, sd_, bd_, sp_, bp_ = (v.to(device=dev, dtype=torch.float32).contiguous()
                                    for v in (se, be, sd, bd, sp, bp))
    return (x, we.to(device=dev, dtype=cdt).contiguous(), se_, be_,
            wd.reshape(k, k, cmid).to(device=dev, dtype=cdt).contiguous(), sd_, bd_,
            wp.to(device=dev, dtype=cdt).contiguous(), sp_, bp_)


def launch(x, we, se, be, wd, sd, bd, wp, sp, bp, *, stride: int, residual: bool,
            p: Plan) -> torch.Tensor:
    """One launch of the kernel with plan ``p`` on the operands of
    :func:`kernel_args`; returns y. Counts nothing: the plan sweep and the
    timings call it."""
    n, h, w, cin = x.shape
    k, cmid, cout = wd.shape[0], we.shape[1], wp.shape[1]
    y = torch.empty((n, out_size(h, k, stride), out_size(w, k, stride), cout),
                    dtype=x.dtype, device=x.device)
    ops = (x, we, se, be, wd, sd, bd, wp, sp, bp, y)
    if any(t.data_ptr() % 16 for t in ops):
        raise ValueError("the MBConv kernel's operands must start on a 16-byte boundary")
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.mbconv_block(
            *(t.data_ptr() for t in ops), n, h, w, cin, cmid, cout, k, stride, int(residual),
            int(x.dtype == torch.bfloat16), p.th, p.tw, p.mc, p.threads, stream)
    _build.check(err, "mbconv_block")
    return y


mbconv_fused.launches = 0

# The op; ``needs_exact_strides`` as for ``dw_conv_bn_act``: x stays contiguous NHWC.
_LIB = torch.library.Library("mnasnet_tpu_torch", "FRAGMENT")
_LIB.define("mbconv_block(Tensor x, Tensor we, Tensor se, Tensor be, Tensor wd, Tensor sd, "
            "Tensor bd, Tensor wp, Tensor sp, Tensor bp, int kernel_size, int stride, "
            "bool residual) -> Tensor", tags=(torch.Tag.needs_exact_strides,))
_LIB.impl("mbconv_block", _mbconv_cpu, "CPU")
_LIB.impl("mbconv_block", _mbconv_cuda, "CUDA")
torch.library.register_fake("mnasnet_tpu_torch::mbconv_block", _mbconv_fake, lib=_LIB)
