"""Frozen counting for EfficientNet: its widths, layer shapes and MACs.

Written out from the published architecture (Tan & Le, arXiv:1905.11946;
torchvision ``efficientnet_b*``) and frozen here, so that a change to the
program cannot change the yardstick its utilisation and roofline shares are
measured against. Nothing here imports the program. The widths and stages
are the configuration file's, in the keys ``counting.py`` reads for
MNASNet (``alpha``, ``base_depths``, ``stacks`` as (kernel, stride,
expansion, repeats), ``head_width``, ``image_size``, ``num_classes``) and
its own: ``first_stage_repeats`` (the MBConv1 stage, k 3, stride 1, no
expand conv) and ``se_ratio``. Every function takes that file's object.
"""

from __future__ import annotations

import math

from benchmark.counting import out_size, round_to_multiple_of


def is_efficientnet(cfg: dict) -> bool:
    return str(cfg.get("arch", "")).startswith("efficientnet")


def depths(cfg: dict) -> list[int]:
    """The stem's and each stage's output width at the configuration's
    width multiplier (``alpha``)."""
    return [round_to_multiple_of(d * cfg["alpha"], 8) for d in cfg["base_depths"]]


def stages(cfg: dict) -> list[tuple[int, int, int, int]]:
    """(kernel, stride, expansion, repeats) of every stage: the MBConv1
    stage, then ``stacks``."""
    return [(3, 1, 1, cfg["first_stage_repeats"])] + [tuple(s) for s in cfg["stacks"]]


def block_shapes(cfg: dict) -> list[tuple]:
    """(name, H, Cin, Cmid, Cout, k, stride, squeeze) of every block (32 in
    B4), H the block's input plane."""
    d = depths(cfg)
    hw, cin, out = out_size(cfg["image_size"], 3, 2), d[0], []
    for s, (k, stride, exp, repeats) in enumerate(stages(cfg)):
        for j in range(repeats):
            st = stride if j == 0 else 1
            cmid = round_to_multiple_of(cin * exp, 8)
            out.append((f"s{s + 1}b{j}", hw, cin, cmid, d[1 + s], k, st,
                        max(1, int(cin * cfg["se_ratio"]))))
            hw, cin = out_size(hw, k, st), d[1 + s]
    return out


def dw_shapes(cfg: dict) -> list[tuple]:
    """(H, C, k, stride) of the depthwise convs of a forward (32 in B4)."""
    return [(h, cmid, k, s) for _, h, _, cmid, _, k, s, _ in block_shapes(cfg)]


def bn_region_shapes(cfg: dict) -> list[tuple]:
    """(name, H, C) of the BN+SiLU regions of a training forward (64 in B4):
    the stem, each block's expand BN (where it has one) and dw BN, the head."""
    d = depths(cfg)
    hw = out_size(cfg["image_size"], 3, 2)
    out = [("stem_bn", hw, d[0])]
    for name, h, cin, cmid, _, k, s, _ in block_shapes(cfg):
        hw = out_size(h, k, s)
        if cmid != cin:  # an expand conv (expansion 1 has none)
            out.append((f"{name}.expand_bn", h, cmid))
        out.append((f"{name}.dw_bn", hw, cmid))
    return out + [("head_bn", hw, cfg["head_width"])]


def count_macs(cfg: dict) -> int:
    """Multiply-accumulates of one image's forward (4,393,771,024 for B4 at
    380 px, 385,814,752 for B0 at 224: torchvision's 4.39 and 0.39 GFLOPS),
    the squeeze-and-excitation's 1x1 convs included."""
    d = depths(cfg)
    hw = out_size(cfg["image_size"], 3, 2)
    macs = 3 * 3 * 3 * d[0] * hw * hw                      # stem conv
    for _, h, cin, cmid, cout, k, s, sq in block_shapes(cfg):
        ho = out_size(h, k, s)
        if cmid != cin:
            macs += cin * cmid * h * h                     # expand
        macs += k * k * cmid * ho * ho                     # dw
        macs += 2 * cmid * sq                              # SE fc1, fc2
        macs += cmid * cout * ho * ho                      # project
        hw = ho
    macs += d[-1] * cfg["head_width"] * hw * hw            # head conv
    macs += cfg["head_width"] * cfg["num_classes"]         # classifier
    return macs


# EfficientNet-B0's stages after the MBConv1 one, (kernel, stride, expansion,
# repeats), and its widths: the family's base.
B0_STACKS = ((3, 2, 6, 2), (5, 2, 6, 2), (3, 2, 6, 3), (5, 1, 6, 3), (5, 2, 6, 4), (3, 1, 6, 1))
B0_DEPTHS = (32, 16, 24, 40, 80, 112, 192, 320)


def family_config(cfg: dict, width: float, depth: float) -> dict:
    """``cfg`` with the widths and stages of the family member at width
    ``width`` and depth ``depth`` (repeats ``ceil(depth * r)``, head four
    times the last width): B0 at (1, 1), B4 at (1.4, 1.8)."""
    import math

    def reps(r):
        return int(math.ceil(r * depth))

    out = {**cfg, "alpha": width, "width_mult": width, "depth_mult": depth,
           "base_depths": list(B0_DEPTHS), "first_stage_repeats": reps(1),
           "stacks": [[k, s, e, reps(r)] for k, s, e, r in B0_STACKS]}
    out["head_width"] = 4 * depths(out)[-1]
    return out
