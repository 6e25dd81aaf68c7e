"""Pretrained-weight loading: torchvision-layout checkpoints into the port's
``MNASNet``. Counterpart of ``mnasnet_tpu/pretrained.py``.

    model = load_pretrained("mnasnet1_0", "mnasnet1_0.pth")   # on cuda
    logits = model(images_nchw)

Accepted files: a torch ``.pth/.pth.tar/.pt`` pickle (a raw state_dict or a
``{"state_dict": ...}`` checkpoint), or an ``.npz`` of arrays keyed by torch
names. A leading ``module.`` is stripped.
"""

from __future__ import annotations

import numpy as np
import torch

from mnasnet_tpu_torch.convert.torch_converter import check_state_dict, strip_module_prefix
from mnasnet_tpu_torch.models.mnasnet import (
    MODEL_REGISTRY,
    MNASNet,
    create_model,
    resolve_device,
)


def load_state_dict_file(path: str) -> dict[str, torch.Tensor]:
    """The state_dict in ``path`` as CPU tensors, ``module.`` stripped."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            sd = {k: torch.from_numpy(np.array(z[k])) for k in z.files}
    elif path.endswith((".pth", ".pth.tar", ".pt")):
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        sd = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    else:
        raise ValueError(f"unsupported checkpoint format: {path!r}")
    return strip_module_prefix(sd)


def load_weights(model: MNASNet, sd: dict[str, torch.Tensor]) -> int:
    """Load a torchvision-layout state_dict into ``model`` in place (strict).

    Transfer learning: when the checkpoint's classifier width differs from
    ``model.num_classes``, the backbone loads from the checkpoint and the
    classifier keeps the model's own. ``num_batches_tracked`` buffers missing
    from a file (they do not affect eval) are taken as 0. Returns the
    checkpoint's classifier width."""
    check_state_dict(sd, model.alpha)
    sd = dict(sd)
    sd.pop("_version", None)
    own = model.state_dict()
    for k, v in own.items():
        if k.endswith("num_batches_tracked"):
            sd.setdefault(k, torch.zeros_like(v))
    ckpt_classes = sd["classifier.1.weight"].shape[0]
    if ckpt_classes != model.num_classes:
        for k in ("classifier.1.weight", "classifier.1.bias"):
            sd[k] = own[k]
    model.load_state_dict(sd, strict=True)
    return ckpt_classes


def load_pretrained(arch: str, path: str, *, device="cuda", seed: int = 0,
                    **model_kwargs) -> MNASNet:
    """The model ``arch`` (a registry name) with the weights in ``path``, in
    eval mode on ``device``; see :func:`load_weights` for transfer learning,
    where the classifier keeps its fresh init from ``seed``."""
    if arch not in MODEL_REGISTRY:
        raise ValueError(f"unknown arch {arch!r}; choices: {sorted(MODEL_REGISTRY)}")
    dev = resolve_device(device)
    model = create_model(arch, device="cpu", seed=seed, **model_kwargs)
    load_weights(model, load_state_dict_file(path))
    return model.to(dev)
