"""Closed-loop training of an EfficientNet: ``train_closed_loop``'s loop,
checked steps and comparison, with EfficientNet's weights, model and plain
reference.

The step is the program's production train step on its train route, as in
``train_closed_loop``; the model is built from the configuration's
``arch`` with its widths (``width_mult``, ``depth_mult``), recipe and BN
settings, and takes the benchmark's seeded torchvision-layout weights
(``weights_efficientnet.py``). The reference (``reference/efficientnet.py``)
follows the checked steps with the same random masks: one draw a step of
the classifier dropout's and the blocks' stochastic-depth columns.
"""

from __future__ import annotations

import time

import torch

from benchmark import common, weights_efficientnet as weights
from benchmark.drivers import train_closed_loop
from benchmark.drivers.train_closed_loop import PHASE, gaps  # noqa: F401
from benchmark.reference import efficientnet as reference


class TrainCell(train_closed_loop.TrainCell):
    """``train_closed_loop.TrainCell`` with an EfficientNet."""

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
        self.model = create_model(
            cfg["arch"], device=device, num_classes=cfg["num_classes"], dropout=cfg["dropout"],
            width_mult=cfg["width_mult"], depth_mult=cfg["depth_mult"],
            stochastic_depth=cfg["stochastic_depth"], dtype=getattr(torch, cfg["compute_dtype"]),
            bn_eps=cfg["bn_eps"], bn_momentum=cfg["bn_momentum"], bn_ema=rec["bn_ema"],
            stem_s2d=rec["stem_s2d"])
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

    def reference(self, quant: str | None = None) -> dict:
        """The reference's readings of the checked steps (``quant``: the FP8
        control, or bf16 rounding)."""
        cfg, k = self.cfg, self.tr["checked_steps"]
        images, labels = self.pool(k)
        keeps = reference.dropout_keep(self.dropout_seed, k, self.batch, cfg, self.device)
        out = reference.train_steps(self.sd, cfg, [(images[j], labels[j]) for j in range(k)],
                                    keeps, weights.decayed(cfg), quant=quant)

        def moved(new: dict) -> dict:
            return {n: float((t.double() - self.sd[n].double()).norm()) for n, t in new.items()}

        return {"losses": out["losses"],
                "grad": {n: float(g.double().norm()) for n, g in out["first_grad"].items()},
                "change": moved(out["params"]), "stats": moved(out["stats"]),
                "planes": out["planes"]}


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
