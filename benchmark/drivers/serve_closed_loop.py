"""Closed-loop serving: one client that sends a batch of uint8 images,
waits for its float32 logits on the host, and sends the next.

Set-up exports the program's serving artifact from the benchmark's weights
(``export_serving``'s raw-input forward, kept in memory) and loads it with
``load_serving`` on the program's route for the batch size, makes a pinned
host pool of ``pool_batches`` distinct seeded batches, and serves three of
them, which captures the route's graph, then serves for ``warmup_seconds``.
A request is one call of the loaded callable on a pool batch and the copy
of its logits into the client's pinned host buffer; its latency runs from
the call to the logits on the host.

The requests whose logits are compared with the reference are drawn from
the seed before the window (each index with probability
``1 / sample_every``, at most ``max_checked`` of those that complete);
their logits are kept, and once the window has closed and the program is
freed the reference computes the same requests' logits.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import common, weights
from benchmark.reference import mnasnet_b1 as reference

PHASE = "serve"


class ServeCell:
    def __init__(self, cfg: dict, tr: dict, seed: int, device):
        from mnasnet_tpu_torch.serving import load_serving
        from mnasnet_tpu_torch.tools.export_serving import build_forward, export_artifact

        self.cfg, self.tr, self.device = cfg, tr, device
        self.batch, size = tr["batch"], cfg["image_size"]
        self.sd = weights.make_state_dict(cfg, seed, device)
        fwd, x = build_forward(cfg["arch"], cfg["num_classes"], cfg["compute_dtype"], self.sd,
                               size, self.batch, dw_impl="kernel", raw_input=True,
                               device=device)
        artifact = export_artifact(fwd, x)
        del fwd, x
        self.predict = load_serving(artifact, route="auto" if device.type == "cuda" else "eager",
                                    device=device)
        g = torch.Generator(device=device).manual_seed(common.sub_seed(seed, 1))
        shape = (tr["pool_batches"], self.batch, size, size, 3)
        made = torch.randint(0, 256, shape, generator=g, device=device, dtype=torch.uint8)
        self.pool = torch.empty(shape, dtype=torch.uint8, pin_memory=device.type == "cuda")
        self.pool.copy_(made)
        del made
        self.host = torch.empty((self.batch, cfg["num_classes"]), dtype=torch.float32,
                                pin_memory=device.type == "cuda")
        rng = np.random.default_rng([seed % (1 << 63), 3])
        self.sampled = rng.random(tr["sample_span"]) < 1.0 / tr["sample_every"]
        self.done = 0
        for _ in range(3):
            self.request()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < tr["warmup_seconds"]:
            self.request()

    def request(self) -> torch.Tensor:
        """One request: the next pool batch in, its logits in the client's
        pinned host buffer (valid until the next request)."""
        images = self.pool[self.done % self.pool.shape[0]]
        self.done += 1
        with record_function("bench.predict"):
            logits = self.predict(images)
        with record_function("bench.copy_out"):
            return self.host.copy_(logits)

    def segment(self, n: int) -> None:
        for _ in range(n):
            self.request()

    def window(self, seconds: float) -> dict:
        """Requests back to back until ``seconds`` have passed: their count,
        failures, latencies, the window's seconds and the sampled logits by
        request index within the window."""
        lat, kept, failed, last = [], {}, 0, {}
        start = self.done
        t0 = time.perf_counter()
        t1 = t0
        while t1 - t0 < seconds:
            i = self.done - start
            try:
                logits = self.request()
            except RuntimeError:
                failed += 1
                logits = None
            now = time.perf_counter()
            lat.append(now - t1)
            t1 = now
            if logits is None:
                continue
            last = {self.done - 1: logits.clone()} if now - t0 >= seconds else last
            if i < len(self.sampled) and self.sampled[i] and len(kept) < self.tr["max_checked"]:
                kept[self.done - 1] = logits.clone()
        # A window too short to reach a sampled request checks its last one.
        return {"requests": len(lat), "failed": failed, "latencies": lat,
                "seconds": t1 - t0, "kept": kept or last}

    def free_program(self) -> None:
        del self.predict
        common.release(self.device)

    def reference_logits(self, index: int, quant: str | None = None) -> torch.Tensor:
        images = self.pool[index % self.pool.shape[0]].to(self.device)
        return reference.serve_logits(self.sd, self.cfg, images, quant=quant).cpu()


def gaps(kept: dict, refs: dict) -> dict:
    """The number compared: the widest row gap of the served logits."""
    return {"logit_gap": max(common.row_gap(kept[i], refs[i]) for i in kept)}


def run(cfg: dict, tr: dict, *, seed: int, seconds: float, trace: bool, device, t0: float
        ) -> dict:
    cell = ServeCell(cfg, tr, seed, device)
    common.settle()
    setup_s = time.perf_counter() - t0
    w = cell.window(seconds)
    done = w["requests"] - w["failed"]
    out = {"attempted": w["requests"], "failed": w["failed"], "phase": PHASE,
           "batch": cell.batch,
           "e2e": {"setup_s": setup_s,
                   "serve_images_per_s": done * cell.batch / w["seconds"],
                   "serve_p95_ms": common.percentile(w["latencies"], 95) * 1e3}}
    if trace:
        units = tr["trace_units"]
        out["trace"], out["units"] = common.traced(device, cell.segment, units), units
    out["memory_peak_bytes"] = common.memory_peak(device)
    cell.free_program()
    kept = w["kept"]
    if not kept:
        raise RuntimeError("no request of the window completed")
    out["checks"] = gaps(kept, {i: cell.reference_logits(i) for i in kept})
    return out
