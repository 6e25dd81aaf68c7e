"""kernel_roofline.train_efficientnet: an EfficientNet's kernels' share of
their roofline in its train cell (device trace): the bound time of the
work of its BN+SiLU regions' four kernels and its training dw forward,
counted by the formulas of their families under kernels/, over their
device time. The other families are not read."""

import copy

from benchmark.roofline import kernel_share

FAMILIES = ("bn_stats_efficientnet", "bn_apply_silu", "bn_reduce_silu", "bn_dx_silu",
            "dw_conv_efficientnet")


def read(r):
    mine = copy.copy(r)
    mine.families = {name: fam for name, fam in r.families.items() if name in FAMILIES}
    return kernel_share(mine, "train")
