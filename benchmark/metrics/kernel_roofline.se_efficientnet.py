"""kernel_roofline.se_efficientnet: an EfficientNet's squeeze-and-excitation
kernels' share of their roofline in its train cell (device trace): the bound
time of the work of the pool, scale, gate-gradient and dx kernels, counted by
the formula of their family under kernels/, over their device time. The other
families are not read; where none of the four kernels ran, nothing is read."""

import copy

from benchmark.roofline import kernel_share

FAMILIES = ("se_efficientnet",)


def read(r):
    mine = copy.copy(r)
    mine.families = {name: fam for name, fam in r.families.items() if name in FAMILIES}
    return kernel_share(mine, "train")
