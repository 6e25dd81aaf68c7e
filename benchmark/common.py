"""Helpers the drivers share: seeds, waiting for the device, the traced
segment, percentiles and the comparisons' gaps."""

from __future__ import annotations

import gc
import math
import shutil
import statistics
import subprocess

import torch

from benchmark.trace import WINDOW, Trace, events_of


def card_line(index: int = 0) -> str | None:
    """``nvidia-smi``'s "name, power limit" of card ``index`` (a card may be
    set below its maximum power and then runs slower under load), or None
    where there is no ``nvidia-smi``."""
    if shutil.which("nvidia-smi") is None:
        return None
    return subprocess.run(["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()


def sub_seed(seed: int, part: int) -> int:
    """A seed of its own for each use of the run's seed (weights 0, inputs
    1, dropout 2, the sample 3), within 63 bits."""
    return (seed * 1_000_003 + part) % (1 << 63) if part else seed % (1 << 63)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def release(device) -> None:
    """Return the program's freed memory before the reference runs."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def settle() -> None:
    """The end of set-up: what set-up left behind is collected, and the
    objects that remain are kept out of the collector's later passes, so
    that a full collection of the loaded program does not fall in the
    window."""
    gc.collect()
    gc.freeze()


def traced(device, segment, units: int) -> Trace:
    """Run ``segment(n)`` (n units of the cell's work, ended by a wait for
    the device) under the profiler: 3 units to start it, then ``units``
    inside the ``bench.window`` span; the window's events."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        segment(3)
        with record_function(WINDOW):
            segment(units)
    return Trace(events_of(prof))


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``th percentile."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q / 100 * len(ordered)) - 1)]


def leaf_gaps(ours: dict, ref: dict, names) -> dict:
    """Each leaf's gap between two norms, |ours - ref|, over the larger of
    the reference's norm of that leaf and of the median leaf."""
    names = list(names)
    median = statistics.median(ref[n] for n in names)
    return {n: abs(ours[n] - ref[n]) / max(ref[n], median, 1e-30) for n in names}


def row_gap(ours: torch.Tensor, ref: torch.Tensor) -> float:
    """The widest gap of any logit from the reference's, over the largest
    |logit| of its row, worst row."""
    ours, ref = ours.double(), ref.double()
    return float(((ours - ref).abs().amax(dim=1)
                  / ref.abs().amax(dim=1).clamp(min=1e-30)).max())
