"""The PyTorch port's input pipeline against the JAX package's: the index
sharding, the loader (synthetic and ImageFolder data, padded tails,
``start_step``, threads, the consumed-index log), the train transform, the
native decoder and the prefetch's cast, exception and shutdown. The port
keeps its own copy of this host code, so everything is held bit for bit."""

import io
import json
import threading
import time
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

import jax.numpy as jnp
import torch

from mnasnet_tpu.data import native_decoder as jax_native
from mnasnet_tpu.data.dataset import ImageFolderDataset as JaxImageFolder
from mnasnet_tpu.data.dataset import SyntheticDataset as JaxSynthetic
from mnasnet_tpu.data.dataset import shard_indices as jax_shard_indices
from mnasnet_tpu.data.pipeline import DataLoader as JaxDataLoader
from mnasnet_tpu.data.pipeline import prefetch_to_device as jax_prefetch
from mnasnet_tpu.data.transforms import eval_transform as jax_eval_transform
from mnasnet_tpu.data.transforms import random_resized_crop_params as jax_rrc_params
from mnasnet_tpu.data.transforms import train_transform as jax_train_transform
from mnasnet_tpu_torch.data import native_decoder
from mnasnet_tpu_torch.data.dataset import ImageFolderDataset, SyntheticDataset, shard_indices
from mnasnet_tpu_torch.data.pipeline import DataLoader, prefetch_to_device
from mnasnet_tpu_torch.data.transforms import (
    eval_transform,
    random_resized_crop_params,
    train_transform,
)

GOLDEN = Path(__file__).resolve().parent / "golden" / "transforms_golden.npz"


@pytest.mark.parametrize("n", [1, 7, 10, 16])
@pytest.mark.parametrize("shards", [1, 3, 4])
def test_shard_indices_match_jax(n, shards):
    for drop_last in (False, True):
        for shuffle in (False, True):
            for epoch in (0, 2):
                for shard in range(shards):
                    kw = dict(shuffle=shuffle, seed=5, shard_id=shard, num_shards=shards,
                              drop_last=drop_last)
                    np.testing.assert_array_equal(shard_indices(n, epoch, **kw),
                                                  jax_shard_indices(n, epoch, **kw))


def _assert_same_batches(ours, ref):
    ours, ref = list(ours), list(ref)
    assert len(ours) == len(ref)
    for (oi, ol), (ri, rl) in zip(ours, ref):
        assert oi.dtype == ri.dtype == np.float32 and ol.dtype == rl.dtype == np.int32
        np.testing.assert_array_equal(oi, ri)
        np.testing.assert_array_equal(ol, rl)
    return ours


@pytest.mark.parametrize("workers", [0, 3])
@pytest.mark.parametrize("drop_last,start_step", [(False, 0), (False, 2), (True, 1)])
def test_loader_matches_jax_on_synthetic_data(workers, drop_last, start_step):
    """11 samples at batch 4: with drop_last=False the third batch has 3 real
    samples and one padded with label -1."""
    kw = dict(shuffle=True, drop_last=drop_last, seed=3, workers=workers)
    ours = DataLoader(SyntheticDataset(11, 24, 5, seed=1), 4,
                      lambda img, rng: train_transform(img, 24, rng), **kw)
    ref = JaxDataLoader(JaxSynthetic(11, 24, 5, seed=1), 4,
                        lambda img, rng: jax_train_transform(img, 24, rng), **kw)
    assert ours.steps_per_epoch() == ref.steps_per_epoch() == (2 if drop_last else 3)
    batches = _assert_same_batches(ours.epoch(1, start_step=start_step),
                                   ref.epoch(1, start_step=start_step))
    if not drop_last:
        labels = batches[-1][1]
        assert (labels[3:] == -1).all() and (labels[:3] >= 0).all()
    serial = DataLoader(SyntheticDataset(11, 24, 5, seed=1), 4,
                        lambda img, rng: train_transform(img, 24, rng),
                        **{**kw, "workers": 0})
    _assert_same_batches(serial.epoch(1, start_step=start_step), batches)


def _jpeg_folder(root, classes=2, per_class=3, seed=0):
    rng = np.random.default_rng(seed)
    for c in range(classes):
        d = root / f"class_{c}"
        d.mkdir(parents=True)
        for i in range(per_class):
            h, w = rng.integers(40, 80, 2)
            base = rng.integers(0, 256, (h // 8 + 1, w // 8 + 1, 3)).astype(np.uint8)
            img = Image.fromarray(base).resize((int(w), int(h)), Image.Resampling.BILINEAR)
            img.save(d / f"{i}.jpg", quality=90)
    # One PNG: the native path falls through to PIL for it.
    Image.fromarray(rng.integers(0, 256, (50, 60, 3), dtype=np.uint8)).save(
        root / "class_0" / "extra.png")
    return root


def _native_or_skip():
    if not native_decoder.available():
        pytest.skip(f"native decoder unavailable: {native_decoder.unavailable_reason}")
    if not jax_native.available():
        pytest.skip("the JAX package's native decoder does not build here")


@pytest.mark.parametrize("path", ["pil", "native"])
@pytest.mark.parametrize("augment", [True, False])
def test_loader_matches_jax_on_an_image_folder(tmp_path, monkeypatch, path, augment):
    """7 images at batch 3 (a padded tail), threads, the consumed-index log."""
    root = _jpeg_folder(tmp_path / "data")
    size = 32
    if path == "native":
        _native_or_skip()
    ours_bytes = ref_bytes = None
    if augment:
        tf = lambda img, rng: train_transform(img, size, rng)  # noqa: E731
        ref_tf = lambda img, rng: jax_train_transform(img, size, rng)  # noqa: E731
        if path == "native":
            ours_bytes = lambda d, rng: native_decoder.decode_train(d, size, rng)  # noqa: E731
            ref_bytes = lambda d, rng: jax_native.decode_train(d, size, rng)  # noqa: E731
    else:
        tf = lambda img: eval_transform(img, size)  # noqa: E731
        ref_tf = lambda img: jax_eval_transform(img, size)  # noqa: E731
        if path == "native":
            ours_bytes = lambda d: native_decoder.decode_eval(d, size)  # noqa: E731
            ref_bytes = lambda d: jax_native.decode_eval(d, size)  # noqa: E731
    kw = dict(shuffle=augment, drop_last=False, seed=2, workers=2, augment=augment)
    ours = DataLoader(ImageFolderDataset(str(root)), 3, tf, bytes_transform=ours_bytes, **kw)
    ref = JaxDataLoader(JaxImageFolder(str(root)), 3, ref_tf, bytes_transform=ref_bytes, **kw)
    logs = {}
    for name, loader in (("ours", ours), ("ref", ref)):
        logs[name] = tmp_path / f"{name}.jsonl"
        monkeypatch.setenv("MNASNET_TPU_CONSUMED_LOG", str(logs[name]))
        batches = list(loader.epoch(1))
        if name == "ours":
            ours_batches = batches
        else:
            _assert_same_batches(ours_batches, batches)
    ours_log = [json.loads(line) for line in logs["ours"].read_text().splitlines()]
    assert ours_log == [json.loads(line) for line in logs["ref"].read_text().splitlines()]
    assert [r["n_valid"] for r in ours_log] == [None, None, 1]
    assert (ours_batches[-1][1][1:] == -1).all()
    assert ours.fallback_count == ref.fallback_count == 0


def test_rrc_params_match_jax():
    """Including the fallback of extreme aspect ratios."""
    for (w, h) in ((300, 400), (1000, 20), (20, 1000), (64, 64), (5, 3)):
        for seed in range(20):
            a, b = np.random.default_rng(seed), np.random.default_rng(seed)
            assert random_resized_crop_params(a, w, h) == jax_rrc_params(b, w, h)
            assert a.random() == b.random()  # the same draws consumed


def test_train_transform_matches_jax_and_the_golden():
    golden = np.load(GOLDEN)
    img = Image.fromarray(golden["image"])
    for key, size, seed in (("train_224_seed7", 224, 7), ("train_96_seed3", 96, 3)):
        ours = train_transform(img, size, np.random.default_rng(seed))
        ref = jax_train_transform(img, size, np.random.default_rng(seed))
        assert ours.dtype == np.float32 and ours.shape == (size, size, 3)
        np.testing.assert_array_equal(ours, ref)
        np.testing.assert_allclose(ours, golden[key], atol=1e-6)


def _jpeg(w, h, seed, quality=92):
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((h // 25 + 1, w // 25 + 1, 3))
    img = np.kron(base, np.ones((25, 25, 1)))[:h, :w]
    img = ((img - img.min()) / (np.ptp(img) + 1e-9) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


@pytest.mark.parametrize("fast", [True, False])
def test_native_decoder_matches_jax(fast):
    _native_or_skip()
    for seed, (w, h) in enumerate(((500, 375), (240, 320), (90, 70))):
        jpeg = _jpeg(w, h, seed)
        assert native_decoder.jpeg_dims(jpeg) == jax_native.jpeg_dims(jpeg) == (w, h)
        np.testing.assert_array_equal(native_decoder.decode_eval(jpeg, 64, fast=fast),
                                      jax_native.decode_eval(jpeg, 64, fast=fast))
        for s in range(3):
            np.testing.assert_array_equal(
                native_decoder.decode_train(jpeg, 48, np.random.default_rng(s), fast=fast),
                jax_native.decode_train(jpeg, 48, np.random.default_rng(s), fast=fast))
    with pytest.raises(ValueError, match="corrupt"):
        native_decoder.decode_eval(b"not a jpeg", 64)


def test_native_fallback_is_counted_per_image():
    """A JPEG the native path rejects falls back to PIL, once per image."""
    _native_or_skip()

    class Mixed:
        def __init__(self):
            self.good = _jpeg(80, 60, 0)

        def __len__(self):
            return 5

        def load_bytes(self, i):
            return (b"broken" if i % 2 else self.good), i

        def load(self, i):
            return Image.open(io.BytesIO(self.good)).convert("RGB"), i

    kw = dict(augment=False, workers=2)
    ours = DataLoader(Mixed(), 5, lambda img: eval_transform(img, 32),
                      bytes_transform=lambda d: native_decoder.decode_eval(d, 32), **kw)
    ref = JaxDataLoader(Mixed(), 5, lambda img: jax_eval_transform(img, 32),
                        bytes_transform=lambda d: jax_native.decode_eval(d, 32), **kw)
    _assert_same_batches(ours.epoch(0), ref.epoch(0))
    assert ours.fallback_count == ref.fallback_count == 2


def _batches(n, shape=(2, 8, 8, 3), seed=0):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        yield ((rng.standard_normal(shape) * 3).astype(np.float32),
               rng.integers(-1, 5, shape[0]).astype(np.int32))


def test_prefetch_cpu_casts_to_bf16_as_the_reference():
    ours = list(prefetch_to_device(_batches(3), device="cpu", dtype=torch.bfloat16))
    ref = list(jax_prefetch(_batches(3), dtype=jnp.bfloat16))
    assert len(ours) == len(ref) == 3
    for (x, y), (rx, ry) in zip(ours, ref):
        assert x.dtype == torch.bfloat16 and x.device.type == "cpu"
        ref_bits = np.asarray(rx).view(np.uint16)
        np.testing.assert_array_equal(x.view(torch.int16).numpy().view(np.uint16), ref_bits)
        np.testing.assert_array_equal(y.numpy(), np.asarray(ry))
    x, _ = next(prefetch_to_device(_batches(1), device="cpu"))
    assert x.dtype == torch.float32


def test_prefetch_reraises_loader_exceptions():
    def gen():
        yield from _batches(1)
        raise ValueError("corrupt JPEG")

    it = prefetch_to_device(gen(), device="cpu")
    next(it)
    with pytest.raises(ValueError, match="corrupt JPEG"):
        next(it)


def test_prefetch_early_exit_stops_the_producer():
    produced = []

    def gen():
        for b in _batches(100, shape=(1, 4, 4, 3)):
            produced.append(1)
            yield b

    before = {t.ident for t in threading.enumerate()}
    it = prefetch_to_device(gen(), device="cpu", size=2)
    next(it)
    it.close()  # the consumer abandons the epoch
    deadline = time.time() + 5.0
    while ({t.ident for t in threading.enumerate()} - before) and time.time() < deadline:
        time.sleep(0.02)
    assert not ({t.ident for t in threading.enumerate()} - before)
    assert len(produced) < 100, "the producer should not have drained the epoch"


def test_fallback_count_is_exact_under_thread_contention():
    """32 worker threads, a short switch interval, every image falling back:
    the count is exact (a lost update would make it short)."""
    import sys

    class AllBroken:
        def __len__(self):
            return 256

        def load_bytes(self, i):
            return b"broken", 0

        def load(self, i):
            return Image.new("RGB", (4, 4)), 0

    def reject(data):
        raise ValueError("corrupt JPEG")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        loader = DataLoader(AllBroken(), 64, lambda img: np.zeros((2, 2, 3), np.float32),
                            augment=False, workers=32, bytes_transform=reject)
        start = time.time()
        assert sum(len(labels) for _, labels in loader.epoch(0)) == 256
        assert time.time() - start < 60
    finally:
        sys.setswitchinterval(interval)
    assert loader.fallback_count == 256
