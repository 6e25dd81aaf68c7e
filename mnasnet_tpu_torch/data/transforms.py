"""torchvision-parity eval transform (PIL and numpy only, host CPU).

Counterpart of the eval half of ``mnasnet_tpu/data/transforms.py``, copied so
that the port never imports the JAX package:
Resize(shorter -> size*256/224, bilinear) -> CenterCrop(size) -> ToTensor ->
Normalize. Output is an HWC float32 array, the layout the JAX package's tests
share; ``make_predict_fn`` takes a batch of them as NHWC. The train-time
transforms are not ported yet.
"""

from __future__ import annotations

import numpy as np
from PIL import Image

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)

_BILINEAR = Image.Resampling.BILINEAR


def resize_shorter(img: Image.Image, size: int) -> Image.Image:
    """torchvision ``Resize(int)``: scale so the shorter side == size,
    preserving aspect ratio (other side truncated, torchvision semantics)."""
    w, h = img.size
    if (w <= h and w == size) or (h <= w and h == size):
        return img
    if w < h:
        ow, oh = size, int(size * h / w)  # torchvision truncates, not rounds
    else:
        ow, oh = int(size * w / h), size
    return img.resize((ow, oh), _BILINEAR)


def center_crop(img: Image.Image, size: int) -> Image.Image:
    """torchvision ``CenterCrop``: pads with zeros if the image is smaller."""
    w, h = img.size
    if w < size or h < size:
        padded = Image.new(img.mode, (max(w, size), max(h, size)))
        padded.paste(img, ((max(w, size) - w) // 2, (max(h, size) - h) // 2))
        img, (w, h) = padded, padded.size
    left = int(round((w - size) / 2.0))
    top = int(round((h - size) / 2.0))
    return img.crop((left, top, left + size, top + size))


def to_float_array(img: Image.Image) -> np.ndarray:
    """ToTensor semantics in HWC: uint8 RGB -> float32 in [0, 1]."""
    return np.asarray(img.convert("RGB"), dtype=np.float32) / 255.0


def normalize(arr: np.ndarray, mean=IMAGENET_MEAN, std=IMAGENET_STD) -> np.ndarray:
    """Channel-wise normalize in float32 (before any bf16 cast)."""
    return (arr - mean) / std


def eval_transform(img: Image.Image, size: int = 224,
                   resize_size: int | None = None) -> np.ndarray:
    if resize_size is None:
        # torchvision convention: resize to size*256/224 (=256 for 224 crops).
        resize_size = int(round(size * 256 / 224))
    img = resize_shorter(img, resize_size)
    img = center_crop(img, size)
    return normalize(to_float_array(img))
