"""Closed-loop training: the program's production train step, steps
dispatched back to back on batches cycled from a pool on the device.

Set-up builds one train step (the model with the benchmark's weights, the
optimizer, the step on the program's train route), makes the pool of
``pool_batches`` distinct seeded batches, and drives the step through its
first ``checked_steps`` steps on pool batches 0, 1, 2: the first call of
the graph route warms up and captures, so nothing is built inside the
window. Those steps are the ones the reference follows: each step's loss,
the first step's gradient as the optimizer got it (worked out from its
state after that step: ``g = mom * sqrt(ms + eps) / lr``), each
parameter's change over the three, and each BN running statistic's change
over the three (the step's external EMA). The window then runs the same
object on the next batches, with at most ``in_flight`` steps queued on the
device, after ``warmup_seconds`` of such steps.
"""

from __future__ import annotations

import collections
import statistics
import time

import torch
from torch.profiler import record_function

from benchmark import common, weights
from benchmark.reference import mnasnet_b1 as reference

PHASE = "train"
# A leaf whose reference gradient is under this share of the median leaf's
# moves by round-off alone (a BN shift followed by another BN): it is left
# out of the comparison.
NOUGHT = 1e-3
# The share of the leaves at or under a ``*_p90`` gap (nearest rank).
SHARE = 90
# The BN leaves of this many of the smallest planes are compared by group.
SMALL_PLANES = 2


class TrainCell:
    """The train step and its pool of ``pool_batches`` batches of ``batch``
    images."""

    def __init__(self, cfg: dict, tr: dict, seed: int, device):
        from mnasnet_tpu_torch import create_model
        from mnasnet_tpu_torch.train.optim import create_optimizer
        from mnasnet_tpu_torch.train.state import TrainState
        from mnasnet_tpu_torch.train.steps import make_train_step
        from mnasnet_tpu_torch.utils.routing import TRAIN_ROUTE

        self.cfg, self.tr, self.device, self.seed = cfg, tr, device, seed
        self.batch = tr["batch"]
        rec = self.rec = cfg["train"]
        self.sd = weights.make_state_dict(cfg, seed, device)
        dtype = getattr(torch, cfg["compute_dtype"])
        self.model = create_model(cfg["arch"], device=device, num_classes=cfg["num_classes"],
                                  dropout=cfg["dropout"], dtype=dtype, bn_ema=rec["bn_ema"],
                                  bn_momentum=cfg["bn_momentum"], stem_s2d=rec["stem_s2d"])
        self.model.load_state_dict(self.sd)
        self.tx = create_optimizer(rec["optimizer"], rec["learning_rate"],
                                   momentum=rec["momentum"], weight_decay=rec["weight_decay"],
                                   rmsprop_decay=rec["rmsprop_decay"],
                                   rmsprop_eps=rec["rmsprop_eps"], fused=rec["fused_updates"])
        self.dropout_seed = common.sub_seed(seed, 2)
        self.state = TrainState.create(self.model, self.tx, seed=self.dropout_seed)
        route = TRAIN_ROUTE if device.type == "cuda" else "eager"
        self.step = make_train_step(self.model, self.tx, label_smoothing=rec["label_smoothing"],
                                    route=route)
        self.images, self.labels = self.pool(tr["pool_batches"])
        self.done = 0
        self.names = [n for n, _ in self.model.named_parameters()]

    def pool(self, batches: int) -> tuple[torch.Tensor, torch.Tensor]:
        """The first ``batches`` batches of the seed: float32 NHWC images and
        labels."""
        cfg, size, n = self.cfg, self.cfg["image_size"], self.batch
        g = torch.Generator(device=self.device).manual_seed(common.sub_seed(self.seed, 1))
        images = torch.randn((self.tr["pool_batches"], n, size, size, 3), generator=g,
                             device=self.device)
        labels = torch.randint(0, cfg["num_classes"], (self.tr["pool_batches"], n), generator=g,
                               device=self.device)
        return images[:batches], labels[:batches]

    def _one(self) -> None:
        j = self.done % self.images.shape[0]
        self.state, _ = self.step(self.state, self.images[j], self.labels[j])
        self.done += 1

    def checked_steps(self) -> dict:
        """The first steps, and what the reference is compared on."""
        lr, eps = self.rec["learning_rate"], self.rec["rmsprop_eps"]
        losses = []
        for i in range(self.tr["checked_steps"]):
            j = self.done
            self.state, metrics = self.step(self.state, self.images[j], self.labels[j])
            self.done += 1
            losses.append(metrics["loss"])
            if i == 0:
                grad = {n: (self.tx.mom[n].double() * (self.tx.ms[n].double() + eps).sqrt()
                            ).norm() / lr for n in self.names}
        params = dict(self.model.named_parameters())
        change = {n: (params[n].detach().double() - self.sd[n].double()).norm()
                  for n in self.names}
        stats = {n: (b.double() - self.sd[n].double()).norm()
                 for n, b in self.model.named_buffers()
                 if n.endswith(("running_mean", "running_var"))}
        common.sync(self.device)
        return {"losses": [float(v) for v in losses],
                "grad": {n: float(v) for n, v in grad.items()},
                "change": {n: float(v) for n, v in change.items()},
                "stats": {n: float(v) for n, v in stats.items()}}

    def steps(self, *, count: int | None = None, seconds: float = 0.0) -> tuple[int, float]:
        """Steps back to back, at most ``in_flight`` queued on the card,
        ``count`` of them or until ``seconds`` have passed, the last ones
        waited for: (steps, seconds from the first to that wait's end)."""
        queued: collections.deque = collections.deque()
        done = 0
        common.sync(self.device)
        t0 = time.perf_counter()
        while done < count if count is not None else time.perf_counter() - t0 < seconds:
            with record_function("bench.step"):
                self._one()
            done += 1
            if self.device.type == "cuda":
                ev = torch.cuda.Event()
                ev.record()
                queued.append(ev)
                if len(queued) > self.tr["in_flight"]:
                    with record_function("bench.wait"):
                        queued.popleft().synchronize()
        with record_function("bench.sync"):
            common.sync(self.device)
        return done, time.perf_counter() - t0

    def free_program(self) -> None:
        """Drop the program's state and the pool."""
        del self.step, self.state, self.tx, self.model, self.images, self.labels
        common.release(self.device)

    def reference(self, quant: str | None = None) -> dict:
        """The reference's readings of the checked steps (``quant``: the FP8
        control, or bf16 rounding)."""
        cfg, k = self.cfg, self.tr["checked_steps"]
        images, labels = self.pool(k)
        keeps = reference.dropout_keep(self.dropout_seed, k, self.batch, cfg["head_width"],
                                       cfg["dropout"], self.device)
        out = reference.train_steps(self.sd, cfg, [(images[j], labels[j]) for j in range(k)],
                                    keeps, weights.decayed(cfg), quant=quant)

        def moved(new: dict) -> dict:
            return {n: float((t.double() - self.sd[n].double()).norm()) for n, t in new.items()}

        return {"losses": out["losses"],
                "grad": {n: float(g.double().norm()) for n, g in out["first_grad"].items()},
                "change": moved(out["params"]), "stats": moved(out["stats"]),
                "planes": out["planes"]}


def counted_leaves(ref: dict) -> list[str]:
    """The parameters whose reference gradient is not nought to round-off."""
    median = statistics.median(ref["grad"].values())
    return [n for n, v in ref["grad"].items() if v >= NOUGHT * median]


def bn_plane_gaps(ours: dict, ref: dict, key: str) -> dict:
    """The BN scales and shifts of each plane taken together: for each group
    ``(rows, "weight" or "bias")`` of counted leaves, the gap of the group's
    norm over the reference's."""
    groups: dict = {}
    for n in counted_leaves(ref):
        bn, _, kind = n.rpartition(".")
        if bn in ref["planes"]:
            g = groups.setdefault((ref["planes"][bn], kind), [0.0, 0.0])
            g[0] += ours[key][n] ** 2
            g[1] += ref[key][n] ** 2
    return {group: abs(a ** 0.5 - b ** 0.5) / b ** 0.5
            for group, (a, b) in sorted(groups.items())}


def gaps(ours: dict, ref: dict) -> dict:
    """The numbers that can be compared: the worst step's loss gap over the
    reference's loss; the gaps of the first gradient's norm, of the
    parameters' change and of the running statistics' change, each leaf's
    over the larger of the reference's norm of that leaf and of the median
    leaf, by the worst leaf, the median leaf and the leaf at the ``SHARE``th
    percentile (parameters with a gradient nought to round-off left out);
    and for the gradient and the change the worst of the BN groups
    (:func:`bn_plane_gaps`) on the ``SMALL_PLANES`` smallest planes. The
    cell's limits say which are compared."""
    counted = counted_leaves(ref)
    out = {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(ours["losses"], ref["losses"]))}
    for name, key, leaves in (("grad", "grad", counted), ("change", "change", counted),
                              ("stat", "stats", list(ref["stats"]))):
        by_leaf = common.leaf_gaps(ours[key], ref[key], leaves)
        out[f"{name}_gap"] = max(by_leaf.values())
        out[f"{name}_gap_median"] = statistics.median(by_leaf.values())
        out[f"{name}_gap_p{SHARE}"] = common.percentile(by_leaf.values(), SHARE)
    small = sorted(set(ref["planes"].values()))[:SMALL_PLANES]
    for key in ("grad", "change"):
        out[f"{key}_bn_small_gap"] = max(gap for (rows, _), gap in
                                         bn_plane_gaps(ours, ref, key).items() if rows in small)
    return out


def run(cfg: dict, tr: dict, *, seed: int, seconds: float, trace: bool, device, t0: float
        ) -> dict:
    cell = TrainCell(cfg, tr, seed, device)
    ours = cell.checked_steps()
    cell.steps(seconds=tr["warmup_seconds"])
    common.settle()
    setup_s = time.perf_counter() - t0
    steps, window_s = cell.steps(seconds=seconds)
    out = {"attempted": steps, "failed": 0, "phase": PHASE, "batch": cell.batch,
           "e2e": {"setup_s": setup_s, "train_images_per_s": steps * cell.batch / window_s}}
    if trace:
        units = tr["trace_units"]
        out["trace"] = common.traced(device, lambda n: cell.steps(count=n), units)
        out["units"] = units
    out["memory_peak_bytes"] = common.memory_peak(device)
    cell.free_program()
    out["checks"] = gaps(ours, cell.reference())
    return out
