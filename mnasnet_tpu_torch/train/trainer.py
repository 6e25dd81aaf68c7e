"""Epoch loop: the reference's ``train`` / ``validate`` loop on one device.

Counterpart of ``mnasnet_tpu/train/trainer.py``. Batches come from
:func:`~mnasnet_tpu_torch.data.pipeline.prefetch_to_device` already on the
device in the compute dtype, and each step's metrics (device tensors) are
read one step late: ``float()`` of a CUDA tensor waits for the card, so the
host reads step j-1's metrics only after it has issued step j. The
batch-time / data-time meters are the reference's.

Cooperative preemption: :meth:`Trainer.request_stop` (from a SIGTERM
handler) makes ``train_epoch`` stop at the next batch boundary;
``stopped_early`` and ``next_global_step`` tell the caller where to save and
where the resumed run starts.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Mapping, Optional

import torch
from torch import nn

from mnasnet_tpu_torch.data.pipeline import prefetch_to_device
from mnasnet_tpu_torch.train.state import TrainState
from mnasnet_tpu_torch.train.steps import make_eval_step, make_train_step
from mnasnet_tpu_torch.utils.meters import AverageMeter, ProgressMeter


@contextlib.contextmanager
def swapped_params(model: nn.Module, params: Optional[Mapping[str, torch.Tensor]]):
    """Run the enclosed code with ``params`` (by parameter name) copied into
    the model's parameters, and the originals copied back after, bit for
    bit. Every route reads the parameters themselves (the MBConv kernel's
    wrapper folds BN from them on each forward), so a copy is what they all
    see. ``params=None`` changes nothing."""
    if params is None:
        yield
        return
    mine = dict(model.named_parameters())
    if set(params) != set(mine):
        raise ValueError("params_override must name every parameter of the model")
    with torch.no_grad():
        saved = {n: p.detach().clone() for n, p in mine.items()}
        for n, p in mine.items():
            p.copy_(params[n])
    try:
        yield
    finally:
        with torch.no_grad():
            for n, p in mine.items():
                p.copy_(saved[n])


class Trainer:
    def __init__(
        self,
        model: nn.Module,
        tx,
        *,
        device=None,
        label_smoothing: float = 0.1,
        compute_dtype: torch.dtype = torch.float32,
        schedule: Optional[Callable[[int], float]] = None,
        print_freq: int = 10,
        writer=None,
        step_tracer=None,
        grad_accum: int = 1,
        diagnostics: bool = False,
    ):
        self.model = model
        self.tx = tx
        self.device = torch.device(device) if device is not None \
            else next(model.parameters()).device
        self.label_smoothing = label_smoothing
        self.compute_dtype = compute_dtype
        self.schedule = schedule
        self.print_freq = print_freq
        self.writer = writer
        self.step_tracer = step_tracer
        # Per-epoch extrema of the diagnostics (grad/update norms, max |logit|)
        # and the train-mode meters of the last train_epoch.
        self.epoch_diag: dict = {}
        self.epoch_train_stats: dict = {}
        self._stop_event = threading.Event()
        self.stopped_early = False
        self.next_global_step: Optional[int] = None
        self._train_step = make_train_step(model, tx, label_smoothing,
                                           diagnostics=diagnostics, grad_accum=grad_accum)
        self._eval_step = make_eval_step(model)

    def create_state(self, seed: int = 0) -> TrainState:
        """Bind the optimizer to the model (fresh state) and seed the dropout
        generator."""
        return TrainState.create(self.model, self.tx, seed=seed)

    def request_stop(self) -> None:
        """Ask the running (or next) ``train_epoch`` to stop at the next batch
        boundary: the current step completes, no new step is issued. Safe
        from a signal handler or another thread. Sticky: once stopped, every
        later ``train_epoch`` returns at once and keeps the first
        ``next_global_step``."""
        self._stop_event.set()

    # ----------------------------------------------------------------- train
    def train_epoch(self, state: TrainState, loader, epoch: int, step_callback=None,
                    step_callback_freq: int = 0, start_step: int = 0) -> TrainState:
        """One training epoch. ``step_callback(state, global_step)`` fires
        every ``step_callback_freq`` steps when set. ``start_step`` resumes
        mid-epoch: the loader skips, without decoding, the batches an
        interrupted run consumed, so a stopped and resumed run equals an
        uninterrupted one bit for bit where the steps are deterministic. On
        ``request_stop()`` it returns early with ``stopped_early`` and
        ``next_global_step`` (the first step the resumed run executes) set."""
        batch_time = AverageMeter("Time", ":6.3f")
        data_time = AverageMeter("Data", ":6.3f")
        losses = AverageMeter("Loss", ":.4e")
        top1 = AverageMeter("Acc@1", ":6.2f")
        top5 = AverageMeter("Acc@5", ":6.2f")
        spe = loader.steps_per_epoch()
        progress = ProgressMeter(spe, [batch_time, data_time, losses, top1, top5],
                                 prefix=f"Epoch: [{epoch}]")
        meters = (losses, top1, top5, progress)
        it = prefetch_to_device(loader.epoch(epoch, start_step=start_step),
                                device=self.device, dtype=self.compute_dtype)
        self.epoch_diag = {}
        self.stopped_early = False
        pending = None  # (metrics, step index), read one step late
        end = time.perf_counter()
        j = start_step - 1  # absolute batch index within the epoch
        for i, (images, labels) in enumerate(it):
            j = start_step + i
            if self._stop_event.is_set():
                # First stop wins: a later train_epoch on a stopped trainer
                # must not move next_global_step past unconsumed batches.
                self.stopped_early = True
                if self.next_global_step is None:
                    self.next_global_step = epoch * spe + j
                break
            data_time.update(time.perf_counter() - end)
            if self.step_tracer is not None:
                self.step_tracer.on_step(epoch * spe + j)
            state, metrics = self._train_step(state, images, labels)
            if pending is not None:
                self._consume(*pending, *meters, epoch, spe)
            pending = (metrics, j)
            if (step_callback is not None and step_callback_freq > 0
                    and (j + 1) % step_callback_freq == 0):
                step_callback(state, epoch * spe + j)
            batch_time.update(time.perf_counter() - end)
            end = time.perf_counter()
        else:
            if self._stop_event.is_set():
                # Stopped between epochs (or during validation): every batch
                # of this epoch ran; the resumed run starts at the boundary.
                self.stopped_early = True
                if self.next_global_step is None:
                    self.next_global_step = epoch * spe + j + 1
        if pending is not None:
            self._consume(*pending, *meters, epoch, spe)
        self.epoch_train_stats = {"loss": losses.avg, "top1": top1.avg, "top5": top5.avg}
        return state

    def _consume(self, metrics, i, losses, top1, top5, progress, epoch, spe):
        n = int(metrics["count"])
        losses.update(float(metrics["loss"]), n)
        top1.update(100.0 * float(metrics["top1"]) / max(n, 1), n)
        top5.update(100.0 * float(metrics["top5"]) / max(n, 1), n)
        if "grad_norm" in metrics:
            d = self.epoch_diag
            for key in ("grad_norm", "update_norm", "max_abs_logit"):
                d[f"max_{key}"] = max(d.get(f"max_{key}", 0.0), float(metrics[key]))
            d["final_param_norm"] = float(metrics["param_norm"])
            d["final_loss"] = float(metrics["loss"])
        if i % self.print_freq == 0:
            progress.display(i)
            if self.writer is not None:
                step = epoch * spe + i
                self.writer.add_scalar("train/loss", losses.val, step)
                self.writer.add_scalar("train/top1", top1.val, step)
                self.writer.add_scalar("train/top5", top5.val, step)
                if self.schedule is not None:
                    self.writer.add_scalar("train/lr", float(self.schedule(step)), step)

    # ------------------------------------------------------------------ eval
    def validate(self, state: TrainState, loader, *, verbose: bool = True,
                 params_override: Optional[Mapping[str, torch.Tensor]] = None):
        """Top-1/top-5 over the val set with running-statistics BN (the
        reference's ``validate()`` with its ``--print-freq`` meters). Returns
        (top1 %, top5 %, loss). ``params_override`` scores other weights by
        parameter name (the ``--model-ema`` shadow) through the same model,
        copied in for the pass and back after."""
        with swapped_params(self.model, params_override):
            return run_validation(self._eval_step, loader, device=self.device,
                                  compute_dtype=self.compute_dtype,
                                  print_freq=self.print_freq, verbose=verbose)


def run_validation(eval_step, loader, *, device, compute_dtype: torch.dtype = torch.float32,
                   print_freq: int = 10, verbose: bool = True):
    """One pass of ``eval_step`` (``make_eval_step(model)``) over ``loader``.
    The padded tail's -1 labels are masked out of the loss and the counts,
    so top-1/top-5 are exact over the real samples. Returns (top1 %,
    top5 %, loss)."""
    batch_time = AverageMeter("Time", ":6.3f")
    losses = AverageMeter("Loss", ":.4e")
    top1 = AverageMeter("Acc@1", ":6.2f")
    top5 = AverageMeter("Acc@5", ":6.2f")
    progress = ProgressMeter(loader.steps_per_epoch(), [batch_time, losses, top1, top5],
                             prefix="Test: ")
    total = {"loss": 0.0, "top1": 0, "top5": 0, "count": 0}
    end = time.perf_counter()
    for i, (images, labels) in enumerate(prefetch_to_device(loader.epoch(0), device=device,
                                                            dtype=compute_dtype)):
        m = eval_step(images, labels)
        n = int(m["count"])
        total["loss"] += float(m["loss"]) * n
        total["top1"] += int(m["top1"])
        total["top5"] += int(m["top5"])
        total["count"] += n
        if n:
            losses.update(float(m["loss"]), n)
            top1.update(100.0 * float(m["top1"]) / n, n)
            top5.update(100.0 * float(m["top5"]) / n, n)
        batch_time.update(time.perf_counter() - end)
        end = time.perf_counter()
        if verbose and i % print_freq == 0:
            progress.display(i)
    c = max(total["count"], 1)
    acc1 = 100.0 * total["top1"] / c
    acc5 = 100.0 * total["top5"] / c
    if verbose:
        print(f" * Acc@1 {acc1:.3f} Acc@5 {acc5:.3f}", flush=True)
    return acc1, acc5, total["loss"] / c
