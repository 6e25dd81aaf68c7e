"""Frozen counting: MNASNet-B1's widths, layer shapes and MACs, and the
card's published peaks.

Copied from the port (``models/mnasnet.py:get_depths, count_macs``,
``tools/tune_plans.py:block_shapes, train_dw_shapes, bn_region_shapes``)
and frozen here, so that a change to the program cannot change the
yardstick its utilisation and roofline shares are measured against.
Nothing here imports the program. The widths and stages are the
configuration file's (``base_depths``, ``stacks``, ``head_width``,
``alpha``, ``image_size``, ``num_classes``): every function takes that
file's object.
"""

from __future__ import annotations

# One NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, 700 W).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12,  # tensor cores, dense
              "float32": 67e12}    # CUDA cores, no TF32


def round_to_multiple_of(val: float, divisor: int = 8, round_up_bias: float = 0.9) -> int:
    """torchvision's rounding of a scaled width."""
    new_val = max(divisor, int(val + divisor / 2) // divisor * divisor)
    return new_val if new_val >= round_up_bias * val else new_val + divisor


def depths(cfg: dict) -> list[int]:
    """The stem, separable and stage widths at the configuration's alpha."""
    return [round_to_multiple_of(d * cfg["alpha"], 8) for d in cfg["base_depths"]]


def out_size(n: int, k: int, stride: int) -> int:
    return (n + 2 * (k // 2) - k) // stride + 1


def block_shapes(cfg: dict) -> list[tuple]:
    """(name, H, Cin, Cmid, Cout, k, stride) of the MBConv blocks (16 in
    MNASNet-B1); ``stacks`` gives each stage's (kernel, stride, expansion,
    repeats)."""
    d = depths(cfg)
    hw, cin, out = cfg["image_size"] // 2, d[1], []
    for s, (k, stride, exp, repeats) in enumerate(cfg["stacks"]):
        for j in range(repeats):
            st = stride if j == 0 else 1
            out.append((f"s{s}b{j}", hw, cin, cin * exp, d[2 + s], k, st))
            hw, cin = out_size(hw, k, st), d[2 + s]
    return out


def dw_shapes(cfg: dict) -> list[tuple]:
    """(H, C, k, stride) of the depthwise convs of a forward (17), in order:
    the separable stem's, then each block's."""
    return [(cfg["image_size"] // 2, depths(cfg)[0], 3, 1)] + [
        (h, cmid, k, s) for _, h, _, cmid, _, k, s in block_shapes(cfg)]


def bn_region_shapes(cfg: dict) -> list[tuple]:
    """(name, H, C) of the BN+ReLU regions of a training forward (35): stem,
    separable dw, each block's expand and dw BN, head."""
    d, hw = depths(cfg), cfg["image_size"] // 2
    out = [("stem_bn", hw, d[0]), ("sep_dw_bn", hw, d[0])]
    for name, h, _, cmid, _, k, s in block_shapes(cfg):
        hw = out_size(h, k, s)
        out += [(f"{name}.expand_bn", h, cmid), (f"{name}.dw_bn", hw, cmid)]
    return out + [("head_bn", hw, cfg["head_width"])]


def count_macs(cfg: dict) -> int:
    """Multiply-accumulates of one image's forward (314,415,872 at alpha 1.0,
    224 px, the published count)."""
    d, head = depths(cfg), cfg["head_width"]
    macs = 0
    hw = cfg["image_size"] // 2  # stem stride 2
    macs += 3 * 3 * 3 * d[0] * hw * hw          # stem conv
    macs += 3 * 3 * d[0] * hw * hw              # sep dw
    macs += d[0] * d[1] * hw * hw               # sep pw
    in_ch = d[1]
    for s, (k, stride, exp, repeats) in enumerate(cfg["stacks"]):
        out_ch = d[2 + s]
        for j in range(repeats):
            st = stride if j == 0 else 1
            mid = in_ch * exp
            macs += in_ch * mid * hw * hw       # expand (pre-stride plane)
            hw_out = (hw + 2 * (k // 2) - k) // st + 1
            macs += k * k * mid * hw_out * hw_out   # dw
            macs += mid * out_ch * hw_out * hw_out  # project
            hw = hw_out
            in_ch = out_ch
    macs += in_ch * head * hw * hw              # head conv
    macs += head * cfg["num_classes"]           # classifier
    return macs


def bound_s(nbytes: float, flops: float, peak: str) -> float:
    """The least time the card could take: bytes at HBM bandwidth or
    operations at the peak rate of ``peak``, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[peak])
