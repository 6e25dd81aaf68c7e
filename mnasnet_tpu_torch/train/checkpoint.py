"""Checkpoints and resume. Counterpart of ``mnasnet_tpu/train/checkpoint.py``
(``CheckpointManager``), with ``torch.save`` in place of orbax.

Layout: one directory per key (the epoch, or under ``preempt/`` the next
global step to run) holding ``checkpoint.pt``: the model's ``state_dict``
(parameters and every BN buffer), the optimizer's state (``count``, ``ms``,
``mom`` or ``trace``, the model-EMA shadow), the ``TrainState`` (``step``
and the dropout generator's state) and ``{epoch, best_acc1, acc1}``, all CPU
tensors and plain numbers, read back with ``torch.load(weights_only=True)``.
A checkpoint is written into a temporary directory beside its key and then
renamed into place, so a kill during a write leaves no torn checkpoint.

Two retention policies, kept apart as in the reference:

  * the latest ``max_to_keep`` keys (pure recency: ``restore()`` resumes
    where training stopped);
  * ``best/``, the single best checkpoint by acc1 (the reference's
    ``model_best.pth.tar``).

One manager keeping the best N would resume an interrupted run from an old
high-water mark instead of its latest epoch. Saves are synchronous;
``wait`` and ``close`` exist for the reference's interface.

Replicas (``replicas``): the state is the same on every replica, so rank 0
alone writes, and every rank waits at a barrier after each save, so that no
rank reads or deletes a key before it is complete. Every rank restores from
the shared directory, and the restored state is then checked against rank
0's by a broadcast. The files do not depend on the world size: a checkpoint
written by W replicas restores at any other W.
"""

from __future__ import annotations

import os
import shutil
from typing import Optional

import torch
from torch import nn

from mnasnet_tpu_torch.parallel.dist import Replicas, assert_replicated, barrier, state_tensors
from mnasnet_tpu_torch.train.state import TrainState

FILE = "checkpoint.pt"


def _cpu(tensors: dict) -> dict:
    return {k: v.detach().cpu().clone() for k, v in tensors.items()}


def find_ema_params(opt_state: dict) -> Optional[dict]:
    """The model-EMA shadow in a saved optimizer state, searching wrapped
    transformations; None when the run kept no model EMA."""
    while opt_state is not None:
        if "ema_params" in opt_state:
            return opt_state["ema_params"]
        opt_state = opt_state.get("inner")
    return None


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3, track_best: bool = True,
                 replicas: Optional[Replicas] = None):
        self.directory = directory
        self.max_to_keep = max_to_keep
        self.replicas = replicas
        self._best = (CheckpointManager(os.path.join(directory, "best"), 1, track_best=False)
                      if track_best else None)

    # ------------------------------------------------------------- layout
    def keys(self) -> list[int]:
        """The saved keys, oldest first."""
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.isfile(os.path.join(self.directory, d, FILE)))

    def latest_epoch(self) -> Optional[int]:
        keys = self.keys()
        return keys[-1] if keys else None

    def best_epoch(self) -> Optional[int]:
        return None if self._best is None else self._best.latest_epoch()

    def _write(self, key: int, payload: dict) -> None:
        final = os.path.join(self.directory, str(key))
        tmp = os.path.join(self.directory, f".tmp-{key}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)  # and the directory itself, on the first save
        torch.save(payload, os.path.join(tmp, FILE))
        old = None
        if os.path.exists(final):  # a key saved again: swap, then drop the old one
            old = os.path.join(self.directory, f".old-{key}-{os.getpid()}")
            os.replace(final, old)
        os.replace(tmp, final)
        if old is not None:
            shutil.rmtree(old)
        for stale in self.keys()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(stale)))

    # --------------------------------------------------------------- save
    def save(self, epoch: int, model: nn.Module, tx, state: TrainState, acc1: float,
             best_acc1: float, wait: bool = False, is_best: bool = False) -> None:
        """Save under key ``epoch``; also as ``best/`` when ``is_best``. With
        replicas rank 0 writes and every rank returns after the write."""
        if self.replicas is None or self.replicas.rank == 0:
            payload = {
                "model": _cpu(model.state_dict()),
                "optimizer": tx.state_dict(),
                "train_state": state.state_dict(),
                "meta": {"epoch": int(epoch), "best_acc1": float(best_acc1),
                         "acc1": float(acc1)},
            }
            self._write(epoch, payload)
            if is_best and self._best is not None:
                self._best._write(epoch, payload)
        barrier(self.replicas)

    # ------------------------------------------------------------ restore
    def _load(self, epoch: Optional[int], best: bool) -> dict:
        mgr = self._best if best else self
        if mgr is None:
            raise FileNotFoundError("no best-checkpoint tracking enabled")
        if epoch is None:
            epoch = mgr.latest_epoch()
        if epoch is None:
            raise FileNotFoundError(f"no checkpoint under {mgr.directory}")
        return torch.load(os.path.join(mgr.directory, str(epoch), FILE), map_location="cpu",
                          weights_only=True)

    def restore(self, model: nn.Module, tx, state: TrainState, epoch: Optional[int] = None,
                best: bool = False) -> tuple[int, float]:
        """Load the latest checkpoint (or ``epoch``, or the best one) into
        ``model``, the optimizer ``tx`` and ``state``, in place. Returns
        (start_epoch, best_acc1). Raises ``FileNotFoundError`` when there is
        none, and ``ValueError`` or ``RuntimeError`` when its structure does
        not match the model or the optimizer."""
        payload = self._load(epoch, best)
        model.load_state_dict(payload["model"], strict=True)
        tx.load_state_dict(payload["optimizer"])
        state.load_state_dict(payload["train_state"])
        assert_replicated([*state_tensors(model, tx), torch.tensor(state.step),
                           state.generator.get_state()], self.replicas, "the restored state")
        meta = payload["meta"]
        return meta["epoch"] + 1, meta["best_acc1"]

    def restore_variables(self, epoch: Optional[int] = None, best: bool = False,
                          use_ema: bool = False) -> tuple[dict, int, float]:
        """The model's state_dict alone, without an optimizer: ``(state_dict,
        epoch, best_acc1)``. The eval path reads weights without rebuilding
        the run's optimizer. ``use_ema=True`` puts the model-EMA shadow of
        the ``--model-ema`` recipe in place of the raw parameters."""
        payload = self._load(epoch, best)
        sd = dict(payload["model"])
        if use_ema:
            ema = find_ema_params(payload["optimizer"])
            if ema is None:
                raise ValueError("checkpoint has no model-EMA shadow params (was the run "
                                 "trained with --model-ema?)")
            sd.update(ema)
        meta = payload["meta"]
        return sd, meta["epoch"], meta["best_acc1"]

    def wait(self) -> None:
        """Saves are synchronous: nothing to wait for."""

    def close(self) -> None:
        """Nothing is held open between saves."""
