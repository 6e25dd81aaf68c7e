"""Convergence proof of the port's training recipe on a learnable synthetic
task, through its ``Trainer`` and loader.

Counterpart of ``tools/train_smoke.py``. Trains mnasnet0_35 @96 on
class-conditional oriented gratings with noise (10 classes,
:class:`GratingDataset`, the reference's numpy rendering bit for bit) with
the full recipe: TF-semantics RMSProp (or SGD), label smoothing 0.1, warmup
then the schedule, weight decay 1e-5 masked off BN and biases, the BN EMA
held outside the module (``bn_ema="external"``), bf16 compute; and writes
the per-epoch curve as JSON, with the reference's keys::

    python -m mnasnet_tpu_torch.tools.train_smoke [--optimizer rmsprop] [--epochs 12]

The step runs on the train route the ``Trainer`` takes (the CUDA graph on
the card). Each epoch is scored in eval mode (running statistics) on the
held-out val set and, through the augmented train loader, on the train set;
``--bn-recalibrate`` adds a score with exact recalibrated statistics
(``train/bn_recal.py``), paired with the weights scored (the model-EMA
shadow's own under ``--model-ema``). The BN EMA decay is 0.9 by default, as
in the reference's smoke: the production 0.9997 keeps most of the (0, 1)
init in the running statistics for thousands of steps, so a short run would
score at chance in eval mode by design; ``--bn-momentum 0.9997`` runs the
production decay, and then only the eval-mode val score may meet the target.

Exits 1 when the target top-1 (``--target-top1``, default 90) is missed.
The output defaults to ``build/train_smoke.json``.

The long production-decay rehearsal (hundreds of epochs) takes three more
flags, with the reference's meaning:

  * ``--state-file PATH`` writes, after every eval point, one ``torch.save``
    file (CPU tensors and plain numbers, written to ``PATH.tmp`` and renamed
    into place): the run identity (every argument but ``--state-file``,
    ``--chunk-epochs``, ``--json`` and ``--workers``), the model's
    ``state_dict``, the optimizer's (RMSProp moments, model-EMA shadow), the
    ``TrainState`` (step, dropout generator), the curve, the next epoch and
    the wall seconds so far. A run that finds the file resumes at its next
    epoch, before the first step (so the graph route captures the restored
    tensors), and refuses a file of another identity;
  * ``--chunk-epochs N`` (with ``--state-file``) returns exit code 3 ("run me
    again") at the first eval point after N epochs of this process, unless
    the run is done: ``while rc == 3`` relaunches it. On the card the reason
    to chunk is a job's time limit; the reference's 20-second pause between
    processes worked around its TPU client and is not needed here;
  * ``--train-rescore-size N`` scores ``train_top1_evalmode`` on the first N
    train images through the eval transform instead of the augmented
    train loader.

Runs longer than 16 epochs keep every rendered grating in memory
(``GratingDataset(cache=True)``), as the reference does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
from PIL import Image


class GratingDataset:
    """Class-conditional oriented gratings under heavy noise.

    Class c of n sets the grating's angle (c·180/n degrees) and a mild color
    tint; each sample draws its own phase, frequency jitter and uniform pixel
    noise, from a generator keyed by (seed, index): the same image at every
    epoch. Noisy enough that the net has to learn real filters, clean enough
    to separate."""

    def __init__(self, length: int, image_size: int, num_classes: int = 10, seed: int = 0,
                 cache: bool = False):
        self.length = length
        self.image_size = image_size
        self.num_classes = num_classes
        self.seed = seed
        self.classes = [f"grating_{i}" for i in range(num_classes)]
        # Each sample is the same at every epoch, so a long run renders it
        # once: ~49 KB an image at 96 px, ~200 MB for 4,096.
        self._cache: dict | None = {} if cache else None

    def __len__(self):
        return self.length

    def render(self, index: int) -> tuple[np.ndarray, int]:
        """The uint8 (S, S, 3) image of sample ``index``, S = image_size + 32,
        and its label."""
        if self._cache is not None and index in self._cache:
            return self._cache[index]
        rng = np.random.default_rng((self.seed, index))
        s = self.image_size + 32
        label = index % self.num_classes
        angle = np.pi * label / self.num_classes
        freq = 2 * np.pi * rng.uniform(4.5, 5.5) / s
        phase = rng.uniform(0, 2 * np.pi)
        yy, xx = np.mgrid[0:s, 0:s].astype(np.float32)
        wave = np.sin((np.cos(angle) * xx + np.sin(angle) * yy) * freq + phase)
        tint = 0.25 + 0.5 * np.array([
            np.cos(2 * np.pi * label / self.num_classes) * 0.5 + 0.5,
            np.sin(2 * np.pi * label / self.num_classes) * 0.5 + 0.5,
            0.5,
        ], dtype=np.float32)
        img = 127.5 + 45.0 * wave[..., None] * tint[None, None, :]
        img = img + rng.uniform(-60, 60, (s, s, 3))
        out = np.clip(img, 0, 255).astype(np.uint8), label
        if self._cache is not None:
            self._cache[index] = out
        return out

    def load(self, index: int):
        arr, label = self.render(index)
        return Image.fromarray(arr), label


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mnasnet0_35")
    ap.add_argument("--image-size", type=int, default=96)
    ap.add_argument("--optimizer", default="rmsprop", choices=["rmsprop", "sgd"])
    ap.add_argument("--lr-schedule", default="cosine")
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--train-size", type=int, default=4096)
    ap.add_argument("--val-size", type=int, default=512)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--json", default=os.path.join("build", "train_smoke.json"),
                    help="where the curve goes")
    ap.add_argument("--target-top1", type=float, default=90.0)
    ap.add_argument("--model-ema", type=float, default=0.0,
                    help="decay of the weights' moving average (0: off); with it the "
                         "curve's val_top1 scores the shadow and val_top1_raw the weights")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--bn-momentum", type=float, default=0.9,
                    help="BN running-statistics EMA decay: 0.9 converges within a short "
                         "smoke; the production 0.9997 needs thousands of steps before "
                         "eval mode catches up")
    ap.add_argument("--warmup-epochs", type=float, default=1.0)
    ap.add_argument("--bn-recalibrate", action="store_true",
                    help="also score each eval point with exact recalibrated BN statistics "
                         "(32 batches mid-run, the whole train epoch at the end), paired "
                         "with the weights scored")
    ap.add_argument("--eval-every", type=int, default=1,
                    help="score in eval mode every N epochs (the last epoch always)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the weight init, the shuffle and augmentation, and the "
                         "dropout masks (the images are the same at every seed)")
    ap.add_argument("--deterministic", action="store_true",
                    help="bit-reproducible runs, as the train CLI's flag: two-pass BN "
                         "statistics, deterministic algorithms, a fixed cuBLAS workspace")
    ap.add_argument("--state-file", default=None,
                    help="resume state, written after every eval point and read at start "
                         "(a file of another run identity is refused)")
    ap.add_argument("--chunk-epochs", type=int, default=0,
                    help="with --state-file: exit 3 at the first eval point after this many "
                         "epochs of this process (state saved); relaunch while rc == 3")
    ap.add_argument("--train-rescore-size", type=int, default=0,
                    help="score train_top1_evalmode on the first N train images through the "
                         "eval transform (0: the whole augmented train loader)")
    args = ap.parse_args(argv)
    if args.chunk_epochs and not args.state_file:
        ap.error("--chunk-epochs needs --state-file")
    return args


# Bookkeeping arguments, which do not change the trajectory
# (tools/train_smoke.py:_config_key).
NOT_IDENTITY = ("state_file", "chunk_epochs", "json", "workers")


def config_key(args) -> str:
    """The run identity a state file is written for: every argument that
    changes the trajectory, as sorted JSON."""
    return json.dumps({k: v for k, v in sorted(vars(args).items()) if k not in NOT_IDENTITY})


def save_state(path: str, payload: dict) -> None:
    """``torch.save`` to ``path.tmp``, then rename into place: a kill during
    the write leaves the previous state."""
    import torch

    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_state(path: str) -> dict:
    import torch

    return torch.load(path, map_location="cpu", weights_only=True)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from mnasnet_tpu_torch.models.mnasnet import resolve_device
    from mnasnet_tpu_torch.train.__main__ import _set_deterministic

    saved = None
    if args.state_file and os.path.exists(args.state_file):
        saved = load_state(args.state_file)
        if saved["config_key"] != config_key(args):
            print(f"train_smoke: {args.state_file} was written by another run:\n"
                  f"  saved: {saved['config_key']}\n  this:  {config_key(args)}",
                  file=sys.stderr, flush=True)
            return 2
    device = resolve_device(args.device)
    prev = torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.benchmark
    if args.deterministic:
        _set_deterministic(device)
    try:
        return run(args, device, saved)
    finally:
        torch.use_deterministic_algorithms(prev[0])
        torch.backends.cudnn.benchmark = prev[1]


def run(args, device, saved) -> int:
    """The smoke itself, from the start or from the ``saved`` state."""
    import torch

    from mnasnet_tpu_torch import create_model
    from mnasnet_tpu_torch.data.pipeline import DataLoader
    from mnasnet_tpu_torch.data.transforms import eval_transform, train_transform
    from mnasnet_tpu_torch.train.bn_recal import recalibrate_bn
    from mnasnet_tpu_torch.train.optim import create_optimizer, get_ema_params
    from mnasnet_tpu_torch.train.schedules import make_schedule
    from mnasnet_tpu_torch.train.trainer import Trainer, swapped_params
    from mnasnet_tpu_torch.utils.card import card_info

    card = card_info(device)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    model = create_model(args.arch, device=device, num_classes=10, dtype=dtype,
                         bn_momentum=args.bn_momentum, bn_ema="external", seed=args.seed,
                         bn_stats="two_pass" if args.deterministic else "one_pass")
    cache = args.epochs > 16  # a long run reads every image hundreds of times
    train_ds = GratingDataset(args.train_size, args.image_size, seed=1, cache=cache)
    val_ds = GratingDataset(args.val_size, args.image_size, seed=2, cache=cache)
    train_loader = DataLoader(
        train_ds, args.batch_size, lambda img, rng: train_transform(img, args.image_size, rng),
        shuffle=True, drop_last=True, seed=args.seed, workers=args.workers)

    def eval_loader(ds):
        return DataLoader(ds, args.batch_size, lambda img: eval_transform(img, args.image_size),
                          shuffle=False, drop_last=False, seed=0, workers=args.workers,
                          augment=False)

    val_loader = eval_loader(val_ds)
    # seed 1: the first N images of the train set, through the eval transform
    rescore_loader = (eval_loader(GratingDataset(min(args.train_rescore_size, args.train_size),
                                                 args.image_size, seed=1, cache=cache))
                      if args.train_rescore_size else train_loader)

    steps_per_epoch = train_loader.steps_per_epoch()
    base_lr = 0.016 if args.optimizer == "rmsprop" else 0.1
    schedule = make_schedule(args.lr_schedule, base_lr, steps_per_epoch, args.epochs,
                             warmup_epochs=args.warmup_epochs)
    tx = create_optimizer(args.optimizer, schedule, model_ema=args.model_ema or None)
    trainer = Trainer(model, tx, device=device, label_smoothing=0.1, compute_dtype=dtype,
                      schedule=schedule, print_freq=10, diagnostics=True,
                      grad_accum=args.grad_accum)
    state = trainer.create_state(args.seed)
    stat_buffers = [b for n, b in model.named_buffers()
                    if n.endswith(("running_mean", "running_var"))]

    curve: list = []
    start_epoch = 0
    t0 = time.time()
    if saved is not None:
        # In place, before the first step: a graph captures these tensors.
        model.load_state_dict(saved["model"], strict=True)
        tx.load_state_dict(saved["optimizer"])
        state.load_state_dict(saved["train_state"])
        curve = saved["curve"]
        start_epoch = saved["next_epoch"]
        t0 -= saved["wall_seconds"]  # the wall clock of every process of the run
        print(f"[smoke] resumed at epoch {start_epoch} from {args.state_file} "
              f"({saved['wall_seconds']:.0f}s so far)", flush=True)

    def write_state(next_epoch: int) -> None:
        if args.state_file:
            save_state(args.state_file, {
                "config_key": config_key(args),
                "model": {k: v.detach().cpu().clone() for k, v in model.state_dict().items()},
                "optimizer": tx.state_dict(), "train_state": state.state_dict(),
                "curve": curve, "next_epoch": next_epoch, "wall_seconds": time.time() - t0})

    def recal_scores(num_batches, tag=""):
        """Val top-1 with exact recalibrated BN statistics, each set of weights
        scored with statistics recomputed under it; the running statistics
        are put back after."""
        saved_stats = [b.clone() for b in stat_buffers]
        try:
            recalibrate_bn(model, train_loader, num_batches=num_batches, compute_dtype=dtype,
                           verbose=False)
            r1, _, rloss = trainer.validate(state, val_loader, verbose=False)
            if args.model_ema:
                with swapped_params(model, get_ema_params(tx)):
                    recalibrate_bn(model, train_loader, num_batches=num_batches,
                                   compute_dtype=dtype, verbose=False)
                    e1, _, eloss = trainer.validate(state, val_loader, verbose=False)
                note = {"val_top1_recal": round(e1, 3), "val_loss_recal": round(eloss, 4),
                        "val_top1_recal_raw": round(r1, 3)}
            else:
                note = {"val_top1_recal": round(r1, 3), "val_loss_recal": round(rloss, 4)}
        finally:
            with torch.no_grad():
                for b, s in zip(stat_buffers, saved_stats):
                    b.copy_(s)
        print(f"[smoke] bn-recal{tag}: val_top1_recal={note['val_top1_recal']:.2f}",
              flush=True)
        return note

    def dump_artifact(recal_note: dict, completed: bool) -> dict:
        # After every eval point: a run cut short keeps its curve so far,
        # marked completed: false.
        final = curve[-1]
        result = {
            **recal_note,
            "task": "class-conditional gratings (10 classes, learnable)",
            "config": {k: v for k, v in vars(args).items() if k != "json"},
            "recipe": {
                "label_smoothing": 0.1, "bn_ema": args.bn_momentum,
                "bn_ema_note": (
                    "production decay (eval-mode statistics need thousands of steps to "
                    "catch up)" if args.bn_momentum >= 0.999 else
                    "production decay is 0.9997; the faster EMA here converges within a "
                    "short smoke (same machinery)"),
                "wd": "1e-5 masked off BN/bias",
                "warmup_epochs": args.warmup_epochs,
                "optimizer_semantics": "TF rmsprop (eps inside sqrt)"
                if args.optimizer == "rmsprop" else "torch sgd+momentum",
            },
            "total_steps": args.epochs * steps_per_epoch,
            "completed": completed,
            "curve": curve,
            # train_top1 is eval mode over the augmented train loader, so the
            # clean val top-1 may meet the target too; under the production
            # decay the eval-mode val score alone counts.
            "reached_target_evalmode": final["val_top1"] >= args.target_top1,
            "reached_target_evalmode_recal": (
                final.get("val_top1_recal", -1.0) >= args.target_top1),
            "reached_target": (
                final["val_top1"] >= args.target_top1 if args.bn_momentum >= 0.999
                else max(final["train_top1"], final["val_top1"]) >= args.target_top1),
            "wall_seconds": round(time.time() - t0, 1),
            "backend": device.type,
            "device_name": card["card"] or "cpu",
            "card": card,
        }
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        tmp = args.json + ".tmp"
        with open(tmp, "w") as f:
            json.dump(result, f, indent=1)
            f.write("\n")
        os.replace(tmp, args.json)
        return result

    epochs_this_process = 0
    for epoch in range(start_epoch, args.epochs):
        state = trainer.train_epoch(state, train_loader, epoch)
        epochs_this_process += 1
        diag = {k: round(v, 4) for k, v in trainer.epoch_diag.items()}
        tstats = {k: round(v, 4) for k, v in trainer.epoch_train_stats.items()}
        if (epoch + 1) % args.eval_every and epoch != args.epochs - 1:
            print(f"[smoke] epoch {epoch}: train_loss={tstats['loss']:.3f} "
                  f"train_top1={tstats['top1']:.2f} (eval skipped) ({time.time() - t0:.0f}s)",
                  flush=True)
            continue
        acc1, _, vloss = trainer.validate(state, val_loader)
        raw_note = {}
        if args.model_ema:
            raw_note = {"val_top1_raw": round(acc1, 3)}
            acc1, _, vloss = trainer.validate(state, val_loader, verbose=False,
                                              params_override=get_ema_params(tx))
        tr1, _, trloss = trainer.validate(state, rescore_loader, verbose=False)
        recal_cols = {}
        if args.bn_recalibrate and epoch != args.epochs - 1:
            recal_cols = recal_scores(32, tag=f" @epoch {epoch}")
        step_now = (epoch + 1) * steps_per_epoch
        curve.append({
            **raw_note, **recal_cols,
            "epoch": epoch, "step": step_now,
            # The share of the (0, 1) init left in the running statistics.
            "bn_init_retention": round(args.bn_momentum ** step_now, 6),
            "train_loss": tstats["loss"], "train_top1": tstats["top1"],
            "train_top1_evalmode": round(tr1, 3), "train_loss_evalmode": round(trloss, 4),
            "val_top1": round(acc1, 3), "val_loss": round(vloss, 4),
            "lr": float(schedule(step_now)),
            **diag,
        })
        print(f"[smoke] epoch {epoch}: train_loss={tstats['loss']:.3f} "
              f"train_top1={tstats['top1']:.2f} val_top1={acc1:.2f} "
              f"max|logit|={diag.get('max_max_abs_logit', 0):.1f} "
              f"gnorm={diag.get('max_grad_norm', 0):.2f} ({time.time() - t0:.0f}s)",
              flush=True)
        dump_artifact({}, completed=False)
        write_state(epoch + 1)
        if (args.chunk_epochs and epoch != args.epochs - 1
                and epochs_this_process >= args.chunk_epochs):
            print(f"[smoke] chunk boundary after epoch {epoch}: state saved to "
                  f"{args.state_file}; exit 3, run again to go on", flush=True)
            return 3

    recal_note = {}
    if args.bn_recalibrate:
        recal_note = recal_scores(None, tag=" (final)")
        curve[-1].update(recal_note)
    final = curve[-1]
    result = dump_artifact(recal_note, completed=True)
    print(json.dumps({k: result[k] for k in ("reached_target", "wall_seconds")}))
    print(f"wrote {args.json}: final train_top1={final['train_top1']} "
          f"val_top1={final['val_top1']}")
    return 0 if result["reached_target"] else 1


if __name__ == "__main__":
    sys.exit(main())
