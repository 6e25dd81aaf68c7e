"""kernel_roofline.serve: the port's kernels' share of their roofline in the
serve cells (device trace): the bound time of their work, counted by the
formulas under kernels/, over their device time."""

from benchmark.roofline import kernel_share


def read(r):
    return kernel_share(r, "serve")
