"""Epoch loop: the reference's ``train`` / ``validate`` loop, on one device or
as one of several data-parallel replicas.

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

Replicas (``replicas``, one process per GPU): the trainer picks the sync-BN
step (``sync_bn``, the default: it gives the model's BatchNorms the handle)
or the local-BN one, and every replica must stop at the same global step, or
the next collective hangs. So each step all-reduces the stop flag (MAX, a
device tensor) and the host reads it one step late, as it reads the
metrics: a stop asked of any one replica stops them all before the same
step, with no host wait added per step. Validation sums its counts over the
replicas' shards; meters, prints and the TensorBoard writer are rank 0's.
The eval step is batch-routed as the reference's (``trainer.py:133,300-312``):
each batch size runs on the route measured fastest for it on the card
(``utils/routing.py``). The train step runs on the train route
(``default_train_route``: ``TRAIN_ROUTE`` on the card, with NCCL replicas
too, where one CUDA graph per input shape holds the step with its
collectives; eager off the card and with gloo replicas), the counterpart
of the reference's one jitted step with donated state
(``trainer.py:122-128``); ``MNASNET_TPU_TORCH_ROUTE`` overrides it. The
agreed stop flag, validation and recalibration stay outside the graph, on
the host.
The train graph keeps a memory pool of its own, apart from the eval graphs'. Every
path that changes the model or the optimizer between steps (checkpoint
restore, BN recalibration, :func:`swapped_params`) writes in place, so a
captured step stays valid across them.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Mapping, Optional

import torch
from torch import nn

from mnasnet_tpu_torch.data.pipeline import prefetch_to_device
from mnasnet_tpu_torch.models.layers import set_replicas
from mnasnet_tpu_torch.parallel.dist import Flag, Replicas, all_reduce_sum_
from mnasnet_tpu_torch.train.state import TrainState
from mnasnet_tpu_torch.train.steps import (
    make_eval_step,
    make_local_bn_train_step,
    make_train_step,
    step_collectives,
)
from mnasnet_tpu_torch.utils.meters import AverageMeter, ProgressMeter
from mnasnet_tpu_torch.utils.routing import BatchRouted


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
        replicas: Optional[Replicas] = None,
        sync_bn: bool = True,
    ):
        if grad_accum > 1 and not sync_bn:
            raise ValueError("grad_accum > 1 with sync_bn=False is redundant: the "
                             "accumulation step already uses per-microbatch (local) BN "
                             "statistics; use sync_bn=True with grad_accum")
        self.model = model
        self.tx = tx
        self.device = torch.device(device) if device is not None \
            else next(model.parameters()).device
        self.replicas = replicas
        self.is_main = replicas is None or replicas.rank == 0
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
        self._layout = (sync_bn, diagnostics, grad_accum)
        set_replicas(model, replicas if sync_bn else None)
        if sync_bn:
            self._train_step = make_train_step(model, tx, label_smoothing, diagnostics=diagnostics,
                                               grad_accum=grad_accum, replicas=replicas)
        else:
            if diagnostics:
                raise ValueError("diagnostics are not kept by the local-BN step")
            self._train_step = make_local_bn_train_step(model, tx, label_smoothing, replicas)
        self._eval_step = BatchRouted(make_eval_step(model), batch_arg=0, device=self.device)

    @property
    def route(self):
        """The train step's :class:`~mnasnet_tpu_torch.utils.routing.TrainRouted`
        (its ``route``, ``calls``, ``replays`` and ``counted()``)."""
        return self._train_step

    def create_state(self, seed: int = 0) -> TrainState:
        """Bind the optimizer to the model (fresh state) and seed the dropout
        generator."""
        return TrainState.create(self.model, self.tx, seed=seed)

    def collectives_per_step(self) -> int:
        """The collectives a step of ``train_epoch`` issues with replicas: the
        step's (``steps.step_collectives``) and the stop flag. On the graph
        route a replay issues the step's on the device, and
        ``Replicas.collectives`` counts them at the warm-up and capture of a
        shape's first call only (``route.counted()``)."""
        return step_collectives(self.model, *self._layout) + 1

    def request_stop(self) -> None:
        """Ask the running (or next) ``train_epoch`` to stop at the next batch
        boundary: the current step completes, no new step is issued. Safe
        from a signal handler or another thread. Sticky: once stopped, every
        later ``train_epoch`` returns at once and keeps the first
        ``next_global_step``. With replicas, a stop asked of one stops all:
        before the next step when asked before an epoch, else one step
        later."""
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
        # With replicas only flags agreed by all decide a stop: the one read
        # at once at the start of the epoch, then each step's, read before
        # the step after next.
        flag = Flag(self._stop_event.is_set(), self.replicas)
        end = time.perf_counter()
        j = start_step - 1  # absolute batch index within the epoch
        for i, (images, labels) in enumerate(it):
            j = start_step + i
            if self.replicas is None:
                stop = self._stop_event.is_set()
            else:
                stop = flag.get()
                flag = Flag(self._stop_event.is_set(), self.replicas)
            if stop:
                self._stop_event.set()
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
            if Flag(self._stop_event.is_set(), self.replicas).get():
                self._stop_event.set()
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
        if i % self.print_freq == 0 and self.is_main:
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
                                  print_freq=self.print_freq, verbose=verbose and self.is_main,
                                  replicas=self.replicas)


def run_validation(eval_step, loader, *, device, compute_dtype: torch.dtype = torch.float32,
                   print_freq: int = 10, verbose: bool = True,
                   replicas: Optional[Replicas] = None):
    """One pass of ``eval_step`` (``make_eval_step(model)``) over ``loader``.
    The padded tail's -1 labels are masked out of the loss and the counts,
    so top-1/top-5 are exact over the real samples. Returns (top1 %,
    top5 %, loss). With ``replicas`` the loader is this replica's shard
    (whose wrap-padding also carries -1 labels) and the sums are taken over
    all shards, one collective at the end; the per-batch meters are this
    replica's."""
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
    if replicas is not None:
        sums = torch.tensor([total[k] for k in ("loss", "top1", "top5", "count")],
                            dtype=torch.float64)
        all_reduce_sum_([sums], replicas, "all_reduce (validation sums)")
        total = dict(zip(("loss", "top1", "top5", "count"), sums.tolist()))
    c = max(total["count"], 1)
    acc1 = 100.0 * total["top1"] / c
    acc5 = 100.0 * total["top5"] / c
    if verbose:
        print(f" * Acc@1 {acc1:.3f} Acc@5 {acc5:.3f}", flush=True)
    return acc1, acc5, total["loss"] / c
