"""Shares of the card's peaks, for the per-layer metrics' readers."""

from __future__ import annotations

import sys

from benchmark import counting


def mfu(r, e2e: str, flops_per_image_mac: int) -> float | None:
    """The whole step's share of the card's bf16 peak: ``flops_per_image_mac``
    operations a multiply-accumulate (2 a forward, 6 a training step) times
    the frozen MACs of an image times the images a second of ``e2e``, over
    the peaks of the cell's cards. Recomputed work is not counted."""
    rate = r.e2e.get(e2e)
    if not rate:
        return None
    macs = counting.count_macs(r.config)
    return 100.0 * flops_per_image_mac * macs * rate / (counting.PEAK_FLOPS["bfloat16"] * r.chips)


def kernel_share(r, phase: str) -> float | None:
    """Sum of the bound times over sum of the device times of the kernel
    families that run in ``phase``, over the traced units. A family none
    of whose kernels ran is off the path and left out; one that ran another
    number of launches than its formula counts makes the share unknown."""
    if r.trace is None or r.phase != phase:
        return None
    bound = device = 0.0
    for name, (spec, mod) in r.families.items():
        per_unit = mod.launches(r.config, r.batch, phase)
        if not per_unit:
            continue
        launches, seconds = r.trace.kernels(spec["patterns"])
        if launches == 0:
            continue
        if launches != len(per_unit) * r.units:
            print(f"roofline: {name} ran {launches} launches in {r.units} units, its formula "
                  f"counts {len(per_unit)} a unit; its share is not read", file=sys.stderr)
            return None
        bound += r.units * sum(counting.bound_s(b, f, spec["peak"]) for _, b, f in per_unit)
        device += seconds
    return 100.0 * bound / device if device else None


def idle_share(r, phase: str) -> float | None:
    if r.trace is None or r.phase != phase or r.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
