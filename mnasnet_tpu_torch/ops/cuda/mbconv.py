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

:func:`mbconv_fused` runs :func:`mbconv_reference` for a CPU tensor and the
kernel for a CUDA tensor; nothing falls back from one to the other. The block
is inference-only: on a CUDA tensor that requires a gradient it raises.
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
# and expanded-channel chunk widths.
THREADS = 512
_TILE_EDGES = (14, 7, 8, 4, 16)
_CHUNKS = (16, 32, 64, 128)
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


def smem_bytes(th: int, tw: int, mc: int, cin: int, cout: int, k: int, stride: int,
               elem_bytes: int) -> int:
    """Shared memory of one block; the same layout as ``mb_layout`` in
    ``csrc/mbconv.cu``: x halo, mid chunk, z chunk (rows padded by 2
    elements), fp32 accumulator, fp32 dw weights and four chunk vectors."""
    halo = ((th - 1) * stride + k) * ((tw - 1) * stride + k)
    return (_align16(halo * (cin + 2) * elem_bytes)
            + _align16(halo * (mc + 2) * elem_bytes)
            + _align16(th * tw * (mc + 2) * elem_bytes)
            + _align16(th * tw * cout * 4)
            + _align16(k * k * mc * 4)
            + _align16(4 * mc * 4))


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
    """The narrowest chunk whose expand step gives every thread a 4x4 tile
    (4 pixels x 4 channels), at most 128 channels and at most Cmid."""
    mc = next((m for m in _CHUNKS if -(-halo_px // 4) * (m // 4) >= THREADS), _CHUNKS[-1])
    return min(mc, cmid)


@functools.lru_cache(maxsize=None)
def plan(h: int, w: int, cin: int, cmid: int, cout: int, k: int, stride: int,
         elem_bytes: int = 2) -> Plan | None:
    """The tile plan of one block shape, or None if none fits.

    Among tiles of at most 256 output pixels it takes the one that expands
    the fewest input pixels (the halo recompute), then one whose edges divide
    the output, then the largest. The chunk width fills the expand step's
    threads (:func:`_chunk`), narrowed until the plan fits ``SMEM_LIMIT``.
    The rule comes from timing every plan of the 16 blocks of mnasnet1_0@224
    at bs128 on an H100 (``python -m mnasnet_tpu_torch.tools.tune_plans``):
    its plans summed to 6.34 ms against 6.19 ms for the fastest plan of each
    block (PERF.md).
    """
    if cin % 2 or cmid % 8 or cout % 4 or k not in (3, 5) or stride not in (1, 2):
        return None
    ho, wo = out_size(h, k, stride), out_size(w, k, stride)
    best, best_key = None, None
    for th in _edges(ho):
        for tw in _edges(wo):
            if th * tw > 256:
                continue
            px = (_expanded_extent(h, ho, th, k, stride)
                  * _expanded_extent(w, wo, tw, k, stride))
            halo = min(h, (th - 1) * stride + k) * min(w, (tw - 1) * stride + k)
            mc = _chunk(halo, cmid)
            while mc > 8 and smem_bytes(th, tw, mc, cin, cout, k, stride, elem_bytes) > SMEM_LIMIT:
                mc //= 2
            smem = smem_bytes(th, tw, mc, cin, cout, k, stride, elem_bytes)
            if smem > SMEM_LIMIT:
                continue
            key = (px, (ho % th != 0) + (wo % tw != 0), -th * tw)
            if best_key is None or key < best_key:
                best, best_key = Plan(th, tw, mc, smem, px, THREADS), key
    return best


def mbconv_fits_smem(H: int, W: int, Cin: int, Cmid: int, Cout: int, k: int, stride: int,
                     elem_bytes: int = 2) -> bool:
    """Whether the fused kernel has a shared-memory plan for this block."""
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
    (sp, bp) (Cout,). Returns (N, Ho, Wo, Cout) in x's dtype. A CPU tensor
    takes :func:`mbconv_reference`; a CUDA tensor launches the kernel
    (``mbconv_fused.launches`` counts those launches) or raises.
    """
    k = kernel_size
    _check(x, we, se, be, wd, sd, bd, wp, sp, bp, k, stride, residual)
    args = (x, we, se, be, wd, sd, bd, wp, sp, bp)
    if x.device.type == "cpu":
        return mbconv_reference(*args, kernel_size=k, stride=stride, residual=residual)
    if x.device.type != "cuda":
        raise ValueError(f"mbconv_fused runs on cpu or cuda, not {x.device}")
    _build.refuse_autograd("mbconv_fused", *args)
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
    dev, cdt = x.device, x.dtype
    we_c = we.to(device=dev, dtype=cdt).contiguous()
    wd_c = wd.reshape(k, k, cmid).to(device=dev, dtype=cdt).contiguous()
    wp_c = wp.to(device=dev, dtype=cdt).contiguous()
    vecs = [v.to(device=dev, dtype=torch.float32).contiguous() for v in (se, be, sd, bd, sp, bp)]
    y = torch.empty((n, out_size(h, k, stride), out_size(w, k, stride), cout),
                    dtype=cdt, device=dev)
    if any(t.data_ptr() % 16 for t in (x, we_c, wp_c, y)):
        raise ValueError("x, we and wp must start on a 16-byte boundary")
    se_, be_, sd_, bd_, sp_, bp_ = vecs
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mbconv_block(
            x.data_ptr(), we_c.data_ptr(), se_.data_ptr(), be_.data_ptr(), wd_c.data_ptr(),
            sd_.data_ptr(), bd_.data_ptr(), wp_c.data_ptr(), sp_.data_ptr(), bp_.data_ptr(),
            y.data_ptr(), n, h, w, cin, cmid, cout, k, stride, int(residual),
            int(cdt == torch.bfloat16), p.th, p.tw, p.mc, p.threads, stream)
    _build.check(err, "mbconv_block")
    mbconv_fused.launches += 1
    return y


mbconv_fused.launches = 0
