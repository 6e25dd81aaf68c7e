"""Train, eval and predict steps. Counterpart of ``mnasnet_tpu/train/steps.py``
(``make_train_step`` with its grad-accumulation form, ``fused_ema_stats``,
``auto_grad_accum``, ``make_eval_step``, ``make_predict_fn``).

A PyTorch module owns its parameters and BN statistics and the optimizer its
state, so the returned functions take the images (and labels) only, plus the
:class:`~mnasnet_tpu_torch.train.state.TrainState` for training. Images are
NHWC, as the JAX package takes them (a batch of ``eval_transform`` outputs);
they go to the model's device and into NCHW channels_last without a copy.
``make_local_bn_train_step`` (per-replica BN across GPUs) is not ported.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch import nn

from mnasnet_tpu_torch.train.loss import cross_entropy, topk_correct
from mnasnet_tpu_torch.train.state import TrainState

# The reference's microbatch limit: on its TPU the bs128->bs256 train step
# lost ~14% to a conv-tiling cliff, so ``auto_grad_accum`` keeps per-chip
# microbatches at or below 128. That is a TPU measurement; the threshold on
# an H100 has not been measured (PERF.md), and this value is kept until it is.
MICROBATCH_LIMIT = 128


def auto_grad_accum(per_chip_batch: int, limit: int = MICROBATCH_LIMIT) -> int:
    """Accumulation factor for ``--grad-accum auto`` (``steps.py:32``): the
    smallest K that divides ``per_chip_batch`` and brings the microbatch to
    at most ``limit``; 1 when the batch fits, or when no divisor exists
    without splitting below ``limit / 2``."""
    if per_chip_batch <= limit:
        return 1
    k0 = -(-per_chip_batch // limit)
    for k in range(k0, 2 * k0 + 1):
        if per_chip_batch % k == 0:
            return k
    return 1


def fused_ema_stats(old: torch.Tensor, batch: torch.Tensor, decay: float) -> torch.Tensor:
    """``decay·old + (1−decay)·batch`` over the whole flattened BN statistics
    in one pass (``steps.py:52``); the same elementwise math as per layer."""
    return decay * old + (1.0 - decay) * batch


def _stat_buffers(model: nn.Module) -> list[torch.Tensor]:
    return [b for name, b in model.named_buffers()
            if name.endswith(("running_mean", "running_var"))]


def _flat(tensors: list[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _ema_outside(model: nn.Module) -> float | None:
    """The BN EMA decay when the model leaves the running-stat EMA to the step."""
    return model.bn_momentum if getattr(model, "bn_ema", "module") == "external" else None


def _global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


def make_train_step(model: nn.Module, tx, label_smoothing: float = 0.1,
                    diagnostics: bool = False, grad_accum: int = 1
                    ) -> Callable[[TrainState, object, object], tuple[TrainState, dict]]:
    """``train_step(state, images NHWC, labels) -> (state, metrics)``
    (``steps.py:81-250``): the model's train-mode forward, the label-smoothed
    loss, the gradients of every parameter, the BN-statistics EMA when the
    model has ``bn_ema="external"`` (one flat :func:`fused_ema_stats`), and
    one optimizer update; ``state.step`` advances by one. Parameters, BN
    statistics and optimizer state update in place; the model's train/eval
    mode is restored on return. ``tx`` is bound to ``model`` by
    ``TrainState.create``.

    ``grad_accum=k`` splits the batch into k microbatches of consecutive
    rows, takes each one's gradients and BN statistics from the same
    parameters, combines the gradients and the loss weighted by each
    microbatch's share of the valid labels and the statistics by their mean,
    and makes one update: the same step as k replicas with per-replica BN.
    It requires ``bn_ema="external"``. ``diagnostics=True`` adds the grad,
    update and param norms and the largest |logit| to the metrics.
    """
    ema_decay = _ema_outside(model)
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    if grad_accum > 1 and ema_decay is None:
        raise ValueError(
            "grad_accum > 1 requires bn_ema='external' on the model: the step "
            "combines per-microbatch BN statistics and applies the running-stats "
            "EMA exactly once per optimizer update")
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    stats = _stat_buffers(model)

    def grads_of(x, y, generator):
        logits = model(x, generator=generator)
        loss = cross_entropy(logits, y, label_smoothing)
        grads = torch.autograd.grad(loss, params)
        return loss.detach(), logits.detach(), grads

    def accumulate(x, y, generator):
        micro = x.shape[0] // grad_accum
        total = (y >= 0).sum().clamp(min=1).float()
        g_acc = [torch.zeros_like(p) for p in params]
        s_acc = torch.zeros(sum(s.numel() for s in stats), device=x.device)
        loss_acc = torch.zeros((), device=x.device)
        counts, maxl = None, torch.zeros((), device=x.device)
        for i in range(grad_accum):
            xi, yi = x[i * micro:(i + 1) * micro], y[i * micro:(i + 1) * micro]
            loss, logits, grads = grads_of(xi, yi, generator)
            w = (yi >= 0).sum().float() / total
            torch._foreach_add_(g_acc, torch._foreach_mul(grads, w))
            s_acc = s_acc + _flat(stats) / grad_accum
            loss_acc = loss_acc + loss * w
            m = topk_correct(logits, yi)
            counts = m if counts is None else {k: counts[k] + m[k] for k in m}
            maxl = torch.maximum(maxl, logits.abs().max())
        return loss_acc, counts, maxl, g_acc, s_acc

    def train_step(state: TrainState, images, labels):
        was_training = model.training
        model.train()
        try:
            x = _images(model, images)
            y = torch.as_tensor(labels).to(x.device)
            if grad_accum > 1 and x.shape[0] % grad_accum:
                raise ValueError(f"batch size {x.shape[0]} not divisible by "
                                 f"grad_accum={grad_accum}")
            old = _flat(stats) if ema_decay is not None else None
            if grad_accum == 1:
                loss, logits, grads = grads_of(x, y, state.generator)
                metrics = {"loss": loss, **topk_correct(logits, y)}
                maxl = logits.abs().max() if diagnostics else None
                new = _flat(stats) if ema_decay is not None else None
            else:
                loss, counts, maxl, grads, new = accumulate(x, y, state.generator)
                metrics = {"loss": loss, **counts}
            with torch.no_grad():
                if ema_decay is not None:
                    v = fused_ema_stats(old, new, ema_decay)
                    torch._foreach_copy_(stats, [t.view_as(s) for t, s in
                                                 zip(v.split([s.numel() for s in stats]), stats)])
                updates = tx.update(dict(zip(names, grads)))
                ups = [updates[n] for n in names]
                torch._foreach_add_(params, ups)
            if diagnostics:
                metrics["grad_norm"] = _global_norm(grads)
                metrics["update_norm"] = _global_norm(ups)
                metrics["param_norm"] = _global_norm(params)
                metrics["max_abs_logit"] = maxl
        finally:
            model.train(was_training)
        state.step += 1
        return state, metrics

    return train_step


def _images(model: torch.nn.Module, images) -> torch.Tensor:
    dev = next(model.parameters()).device
    x = images if torch.is_tensor(images) else torch.from_numpy(np.asarray(images))
    return x.to(dev, non_blocking=True).permute(0, 3, 1, 2)


def make_eval_step(model: torch.nn.Module, label_smoothing: float = 0.0):
    """eval_step(images, labels) -> metrics (running-stats BN, no dropout)."""

    @torch.inference_mode()
    def eval_step(images, labels):
        logits = model(_images(model, images))
        labels = torch.as_tensor(labels).to(logits.device)
        return {
            "loss": cross_entropy(logits, labels, label_smoothing),
            **topk_correct(logits, labels),
        }

    return eval_step


def make_predict_fn(model: torch.nn.Module):
    """predict(images NHWC) -> fp32 logits: the single-image request path and
    the serving path."""

    @torch.inference_mode()
    def predict(images):
        return model(_images(model, images))

    return predict
