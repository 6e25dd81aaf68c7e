"""torchvision-parity image transforms (PIL and numpy only, host CPU).

A copy of ``mnasnet_tpu/data/transforms.py``, so that the port never imports
the JAX package:

  * train: RandomResizedCrop(size, scale=(0.08, 1), ratio=(3/4, 4/3),
    bilinear) -> RandomHorizontalFlip(0.5) -> ToTensor -> Normalize;
  * eval: Resize(shorter -> size*256/224, bilinear) -> CenterCrop(size) ->
    ToTensor -> Normalize.

Output is an HWC float32 array, the layout the JAX package's tests share;
``make_predict_fn`` and the train step take a batch of them as NHWC. The
train transform draws from the ``np.random.Generator`` it is given in the
reference's order, so the same generator gives the same array.
"""

from __future__ import annotations

import math

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


def random_resized_crop_params(
    rng: np.random.Generator,
    width: int,
    height: int,
    scale: tuple[float, float] = (0.08, 1.0),
    ratio: tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
) -> tuple[int, int, int, int]:
    """Sample (top, left, h, w) with torchvision's algorithm: 10 attempts of
    area in scale*A, log-uniform aspect in ratio; then the documented
    center-crop fallback clamped to the ratio range."""
    area = float(width * height)
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect = math.exp(rng.uniform(log_ratio[0], log_ratio[1]))
        w = int(round(math.sqrt(target_area * aspect)))
        h = int(round(math.sqrt(target_area / aspect)))
        if 0 < w <= width and 0 < h <= height:
            top = int(rng.integers(0, height - h + 1))
            left = int(rng.integers(0, width - w + 1))
            return top, left, h, w
    # Fallback: center crop at the closest in-range aspect ratio.
    in_ratio = width / height
    if in_ratio < ratio[0]:
        w = width
        h = int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        h = height
        w = int(round(h * ratio[1]))
    else:
        w, h = width, height
    top = (height - h) // 2
    left = (width - w) // 2
    return top, left, h, w


def random_resized_crop(
    img: Image.Image,
    size: int,
    rng: np.random.Generator,
    scale: tuple[float, float] = (0.08, 1.0),
    ratio: tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
) -> Image.Image:
    top, left, h, w = random_resized_crop_params(rng, *img.size, scale, ratio)
    # Crop THEN resize (torchvision resized_crop semantics). One
    # resize(box=...) call is not the same: PIL clamps the filter support to
    # the full image, so pixels outside the box bleed into the edge rows and
    # columns.
    return img.crop((left, top, left + w, top + h)).resize((size, size), _BILINEAR)


def to_float_array(img: Image.Image) -> np.ndarray:
    """ToTensor semantics in HWC: uint8 RGB -> float32 in [0, 1]."""
    return np.asarray(img.convert("RGB"), dtype=np.float32) / 255.0


def normalize(arr: np.ndarray, mean=IMAGENET_MEAN, std=IMAGENET_STD) -> np.ndarray:
    """Channel-wise normalize in float32 (before any bf16 cast)."""
    return (arr - mean) / std


def train_transform(img: Image.Image, size: int, rng: np.random.Generator) -> np.ndarray:
    img = random_resized_crop(img, size, rng)
    if rng.random() < 0.5:
        img = img.transpose(Image.Transpose.FLIP_LEFT_RIGHT)
    return normalize(to_float_array(img))


def eval_transform(img: Image.Image, size: int = 224,
                   resize_size: int | None = None) -> np.ndarray:
    if resize_size is None:
        # torchvision convention: resize to size*256/224 (=256 for 224 crops).
        resize_size = int(round(size * 256 / 224))
    img = resize_shorter(img, resize_size)
    img = center_crop(img, size)
    return normalize(to_float_array(img))
