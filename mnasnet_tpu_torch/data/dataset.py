"""Datasets: ImageFolder (torchvision layout) and synthetic FakeData, and the
per-epoch index sharding. A copy of ``mnasnet_tpu/data/dataset.py``.

``ImageFolderDataset`` mirrors ``torchvision.datasets.ImageFolder``: class
subdirectories sorted lexicographically give contiguous label ids; images are
found recursively in each class directory. ``SyntheticDataset`` is the
FakeData stand-in of ``--synthetic`` runs, seeded by ``(seed, index)``.
"""

from __future__ import annotations

import os

import numpy as np
from PIL import Image

IMG_EXTENSIONS = (
    ".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif", ".tiff", ".webp",
)


class ImageFolderDataset:
    """root/class_x/*.jpg layout -> (PIL image, int label) samples."""

    def __init__(self, root: str):
        self.root = root
        classes = sorted(d.name for d in os.scandir(root) if d.is_dir())
        if not classes:
            raise FileNotFoundError(f"no class directories under {root!r}")
        self.classes = classes
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples: list[tuple[str, int]] = []
        for c in classes:
            cdir = os.path.join(root, c)
            for dirpath, _dirnames, filenames in sorted(os.walk(cdir)):
                for fname in sorted(filenames):
                    if fname.lower().endswith(IMG_EXTENSIONS):
                        self.samples.append((os.path.join(dirpath, fname), self.class_to_idx[c]))
        if not self.samples:
            raise FileNotFoundError(f"no images under {root!r}")

    def __len__(self) -> int:
        return len(self.samples)

    def load(self, index: int) -> tuple[Image.Image, int]:
        path, label = self.samples[index]
        with Image.open(path) as img:
            return img.convert("RGB"), label

    def load_bytes(self, index: int):
        """(raw JPEG bytes | None, label): bytes for the native fused decoder
        (``data/native_decoder.py``); None for a file that is not a JPEG."""
        path, label = self.samples[index]
        if path.lower().endswith((".jpg", ".jpeg")):
            with open(path, "rb") as f:
                return f.read(), label
        return None, label


class SyntheticDataset:
    """Deterministic random-image dataset (index-seeded, so every worker and
    every epoch sees the same content for a given index)."""

    def __init__(self, length: int = 1024, image_size: int = 224,
                 num_classes: int = 1000, seed: int = 0):
        self.length = length
        self.image_size = image_size
        self.num_classes = num_classes
        self.seed = seed
        self.classes = [f"class_{i}" for i in range(num_classes)]

    def __len__(self) -> int:
        return self.length

    def load(self, index: int) -> tuple[Image.Image, int]:
        rng = np.random.default_rng((self.seed, index))
        # Larger than the target so RandomResizedCrop has room to crop.
        s = self.image_size + 32
        arr = rng.integers(0, 256, (s, s, 3), dtype=np.uint8)
        label = int(rng.integers(0, self.num_classes))
        return Image.fromarray(arr), label


def shard_indices(
    n: int,
    epoch: int,
    *,
    shuffle: bool,
    seed: int,
    shard_id: int,
    num_shards: int,
    drop_last: bool,
) -> np.ndarray:
    """Per-epoch index shard, the DistributedSampler contract: the same
    permutation on every process (seeded by (seed, epoch)), then strided
    assignment so each sample is seen once per epoch across shards. With
    ``drop_last=False`` the tail is padded by wrapping, so all shards have
    the same length."""
    if shuffle:
        order = np.random.default_rng((seed, epoch)).permutation(n)
    else:
        order = np.arange(n)
    if drop_last:
        usable = (n // num_shards) * num_shards
        order = order[:usable]
    else:
        target = -(-n // num_shards) * num_shards
        if target > n:
            order = np.concatenate([order, order[: target - n]])
    return order[shard_id::num_shards]
