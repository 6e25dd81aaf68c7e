"""The card a measurement ran on, and timing on it.

Every record of the port's measurement tools carries :func:`card_info`: the
card's name and power limit as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` gives them (a card may be set below its maximum
power, and then runs slower under load), and the versions of torch and
CUDA. :func:`open_device` refuses a CUDA device that is not there, so that
a tool never measures the CPU in its place. :func:`interleaved_ms` times
callables on the card with CUDA events, in turns, as the median of repeats.
"""

from __future__ import annotations

import shutil
import statistics
import subprocess
import sys

import torch


def card_line(index: int = 0) -> str | None:
    """``nvidia-smi``'s "name, power limit" line of card ``index``, or None
    where there is no ``nvidia-smi``."""
    if shutil.which("nvidia-smi") is None:
        return None
    out = subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def card_info(device: torch.device) -> dict:
    """What a record says of where it ran: on the CPU the card's keys are null."""
    on_card = device.type == "cuda"
    line = card_line(device.index or 0) if on_card else None
    power = (line or "").rpartition(", ")[2]
    return {"device": str(device),
            "card": torch.cuda.get_device_name(device) if on_card else None,
            "nvidia_smi": line,
            "power_limit": power or None,
            "torch": torch.__version__,
            "cuda": torch.version.cuda if on_card else None}


def open_device(name: str, tool: str) -> torch.device:
    """``torch.device(name)``; exits with code 2 and a message when ``name``
    asks for a CUDA device and there is none. Nothing falls back to the CPU:
    ``--device cpu`` must be asked for."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"{tool}: no CUDA device for --device {name!r} (pass --device cpu to run the "
              "plain versions on the CPU at a small size)", file=sys.stderr)
        raise SystemExit(2)
    return device


def interleaved_ms(fns: dict, repeats: int = 5, target_ms: float = 100.0) -> dict:
    """{name: [ms per call of each repeat]} of each callable on the card.

    Each callable is called twice, then timed in ``repeats``
    rounds: in each round one window of calls per callable, in turns (the
    order reversed every other round, so that neither always goes first),
    timed with CUDA events; a window holds enough calls to last about
    ``target_ms``. Take the median of each list."""
    if repeats < 1:
        raise ValueError(f"repeats must be >= 1, got {repeats}")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def window(fn, calls: int) -> float:
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / calls

    iters = {}
    for name, fn in fns.items():
        for _ in range(2):
            fn()
        iters[name] = int(min(1000, max(1, target_ms / max(window(fn, 1), 1e-3))))
    out: dict = {name: [] for name in fns}
    names = list(fns)
    for r in range(repeats):
        for name in (names if r % 2 == 0 else names[::-1]):
            out[name].append(window(fns[name], iters[name]))
    return out


def median(values: list | None) -> float | None:
    return None if not values else statistics.median(values)
