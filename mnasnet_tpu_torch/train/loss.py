"""Label-smoothed cross-entropy and top-k accuracy.

Counterpart of ``mnasnet_tpu/train/loss.py``. The loss matches
``nn.CrossEntropyLoss(label_smoothing=eps)``. Labels < 0 are padding sentinels
(fixed-shape tail batches) and are masked out of both loss and accuracy.
"""

from __future__ import annotations

import torch


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean label-smoothed softmax CE over valid (label >= 0) samples.

    logits (B, K), labels (B,) int (-1 = padding).
    """
    mask = labels >= 0
    safe_labels = labels.clamp(min=0).long()
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    nll = -log_probs.gather(-1, safe_labels[:, None])[:, 0]
    if label_smoothing > 0.0:
        smooth = -log_probs.mean(dim=-1)
        nll = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    nll = torch.where(mask, nll, torch.zeros_like(nll))
    return nll.sum() / mask.sum().clamp(min=1)


def topk_correct(logits: torch.Tensor, labels: torch.Tensor,
                 ks=(1, 5)) -> dict[str, torch.Tensor]:
    """Top-k-correct counts per k plus the valid-sample ``count``, summable
    across batches."""
    mask = labels >= 0
    maxk = min(max(ks), logits.shape[-1])  # top-5 on a 4-class head is top-4
    pred = logits.topk(maxk, dim=-1).indices
    correct = (pred == labels[:, None]) & mask[:, None]
    out = {f"top{k}": correct[:, :min(k, maxk)].any(dim=1).sum() for k in ks}
    out["count"] = mask.sum().to(torch.int32)
    return out
