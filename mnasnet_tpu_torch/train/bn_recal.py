"""Exact BatchNorm running-statistics recalibration ("BN recal").

Counterpart of ``mnasnet_tpu/train/bn_recal.py``. With the production BN EMA
decay 0.9997 the running statistics keep ``0.9997**n`` of their (0, 1) init
after n steps, and lag the weights by a ~3.3k-step horizon after a short
run, a fine-tune or a restore with fresh statistics. Recalibration replaces
them with exact pooled statistics over training batches, weights frozen.

Math. For batches b = 1..N with per-batch channel mean ``m_b`` and
(Bessel-corrected) variance ``v_b``::

    mu  = sum(m_b) / N
    var = sum(v_b) / N  +  (sum(m_b^2) / N - mu^2)

the mean within-batch variance plus the between-batch spread of the means,
which a per-batch EMA, and ``torch.optim.swa_utils.update_bn``, drop. The
within term keeps each batch's n/(n-1) Bessel factor (an O(1/n) difference
from re-correcting over N*n elements).

Feed it a ``drop_last`` loader: a padded tail batch would fold its
wrap-padding duplicates into the statistics, and BN has no validity mask.
:func:`recalibrate_bn` refuses other loaders.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mnasnet_tpu_torch.data.pipeline import prefetch_to_device
from mnasnet_tpu_torch.models.layers import BatchNorm


def _combine(sum_s: dict, sum_sq: dict, n: int) -> dict:
    """Pooled running statistics from the per-buffer sums of the per-batch
    raw statistics (``sum_s``) and of the squared means (``sum_sq``)."""
    out = {}
    for name, s in sum_s.items():
        if name.endswith("running_mean"):
            mu = s / n
            between = torch.clamp_min(sum_sq[name] / n - mu * mu, 0.0)
            out[name] = mu
            out[name[:-len("mean")] + "var"] = sum_s[name[:-len("mean")] + "var"] / n + between
    return out


def make_recal_step(model: nn.Module):
    """``step(images) -> {buffer name: raw batch statistic}``: one
    training-mode forward under ``torch.no_grad`` from zeroed running
    statistics. With ``bn_ema="external"`` each BN writes the raw batch mean
    and Bessel variance; with ``bn_ema="module"`` it writes
    ``momentum*0 + (1-momentum)*raw``, so dividing by ``1-momentum`` gives
    the raw values back (nothing is subtracted, so nothing cancels). Dropout,
    which sits above every BN, draws from a fixed generator of its own."""
    bns = {name: m for name, m in model.named_modules() if isinstance(m, BatchNorm)}
    module_ema = getattr(model, "bn_ema", "module") == "module"
    inv = 1.0 / (1.0 - float(getattr(model, "bn_momentum", 0.9997)))
    dev = next(model.parameters()).device
    generator = torch.Generator(device=dev).manual_seed(0)

    @torch.no_grad()
    def step(images: torch.Tensor) -> dict:
        for bn in bns.values():
            bn.running_mean.zero_()
            bn.running_var.zero_()
        was_training = model.training
        model.train()
        try:
            model(images.permute(0, 3, 1, 2), generator=generator)
        finally:
            model.train(was_training)
        raw = {}
        for name, bn in bns.items():
            for buf in ("running_mean", "running_var"):
                v = getattr(bn, buf).clone()
                raw[f"{name}.{buf}"] = v * inv if module_ema else v
        return raw

    return step


def recalibrate_bn(model: nn.Module, loader, *, num_batches: Optional[int] = None,
                   compute_dtype: torch.dtype = torch.float32, verbose: bool = True) -> dict:
    """Replace the model's BN running statistics with exact pooled statistics
    over ``loader`` (at most ``num_batches`` batches; None = one epoch).
    Weights are untouched, and so is ``num_batches_tracked``. Returns the new
    statistics by buffer name; they are also in the model."""
    if not getattr(loader, "drop_last", True):
        raise ValueError(
            "recalibrate_bn needs a drop_last loader: a wrap-padded tail batch would fold "
            "padding into the pooled statistics (there is no validity mask inside BN). "
            "Rebuild the loader with drop_last=True, as the train CLI's train loader is.")
    dev = next(model.parameters()).device
    bns = {name: m for name, m in model.named_modules() if isinstance(m, BatchNorm)}
    tracked = {name: bn.num_batches_tracked.clone() for name, bn in bns.items()}
    step = make_recal_step(model)
    sum_s: dict = {}
    sum_sq: dict = {}
    n = 0
    for images, _labels in prefetch_to_device(loader.epoch(0), device=dev, dtype=compute_dtype):
        raw = step(images)
        for name, v in raw.items():
            sum_s[name] = sum_s[name] + v if name in sum_s else v
            if name.endswith("running_mean"):
                sum_sq[name] = sum_sq[name] + v * v if name in sum_sq else v * v
        n += 1
        if num_batches is not None and n >= num_batches:
            break
    if n == 0:
        raise ValueError("recalibrate_bn: loader yielded no batches")
    new_stats = _combine(sum_s, sum_sq, n)
    with torch.no_grad():
        for name, bn in bns.items():
            bn.running_mean.copy_(new_stats[f"{name}.running_mean"])
            bn.running_var.copy_(new_stats[f"{name}.running_var"])
            bn.num_batches_tracked.copy_(tracked[name])
    if verbose:
        print(f"[bn-recal] running stats recomputed over {n} batches "
              f"(exact pooled moments, weights untouched)", flush=True)
    return new_stats
