"""One run of one cell: its files found by name, its driver run, its
metrics read, its comparison judged, and the result's line built."""

from __future__ import annotations

import math

import torch

from benchmark import registry


class Reading:
    """What a per-layer metric's reader reads: the cell's configuration,
    the run's end-to-end values, the traced window and the number of units
    (requests or steps) in it, the cell's cards and the kernel families."""

    def __init__(self, cell: dict, cfg: dict, out: dict, families: dict):
        self.config = cfg
        self.e2e = out["e2e"]
        self.phase, self.batch = out["phase"], out["batch"]
        self.trace, self.units = out.get("trace"), out.get("units", 0)
        self.chips = cell["chips"]
        self.families = families


def kernel_shapes(cfg: dict, batch: int, phase: str, families: dict) -> list[str]:
    """One line per kernel family: the shapes its work is counted at."""
    return [f"shapes {name} {phase}: {[shape for shape, _, _ in mod.launches(cfg, batch, phase)]}"
            for name, (_, mod) in families.items() if mod.launches(cfg, batch, phase)]


def run_cell(name: str, *, seed: int, seconds: float, trace: bool, device, t0: float,
             config_overrides: dict | None = None, traffic_overrides: dict | None = None,
             log=print) -> dict:
    """The result's object of one run (every key of the line, ``checks``
    last). The overrides replace keys of the configuration and the traffic
    (tests run a cell's path at a small size on the CPU)."""
    bench = registry.manifest()
    cell = registry.cell(name, bench)
    cfg = {**registry.config(cell["config"]), **(config_overrides or {})}
    tr = {**registry.traffic(cell["traffic"]), **(traffic_overrides or {})}
    limits = registry.limits(name)
    out = registry.driver(tr["driver"]).run(cfg, tr, seed=seed, seconds=seconds, trace=trace,
                                            device=device, t0=t0)
    checks = {k: {"value": out["checks"][k], "limit": lim["limit"]} for k, lim in limits.items()}
    correct = out["failed"] == 0 and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                                         for c in checks.values())
    metrics: dict = {}
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"]}
    on_card = device.type == "cuda"
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": cell["chips"], "memory_peak_bytes": out["memory_peak_bytes"]}
    if not trace:
        for m in bench["end_to_end"]:
            if registry.applies(m, name):
                metrics[m["name"]] = {"value": out["e2e"][m["name"]], "unit": m["unit"]}
    else:
        families = registry.kernel_families()
        for line in kernel_shapes(cfg, out["batch"], out["phase"], families):
            log(line)
        reading = Reading(cell, cfg, out, families)
        for m in bench["per_layer"]:
            if registry.applies(m, name):
                value = registry.metric_reader(m["name"]).read(reading)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        t = out["trace"]
        # Averaged over the cards where the run read each card's trace.
        dev["busy_s"], dev["window_s"] = out.get("busy_window", (t.busy_s, t.window_s))
        result["breakdown"] = {"device_ops": t.top_device_ops(), "idle_gaps": t.idle_by_span()}
    result["metrics"] = metrics
    result["device"] = dev
    result["checks"] = checks
    return result
