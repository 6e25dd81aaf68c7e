"""device_idle.serve: the share of the traced window in which the card ran
no kernel and no copy (the union of the device's intervals), serve cells."""

from benchmark.roofline import idle_share


def read(r):
    return idle_share(r, "serve")
