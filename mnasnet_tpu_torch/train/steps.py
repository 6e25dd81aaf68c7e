"""Eval and predict steps. Counterpart of ``make_eval_step`` and
``make_predict_fn`` in ``mnasnet_tpu/train/steps.py``; the training steps
are not ported yet.

A PyTorch module owns its parameters, so the returned functions take the
images (and labels) only. Images are NHWC, as the JAX package takes them
(a batch of ``eval_transform`` outputs); they go to the model's device and
into NCHW channels_last without a copy.
"""

from __future__ import annotations

import numpy as np
import torch

from mnasnet_tpu_torch.train.loss import cross_entropy, topk_correct


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
