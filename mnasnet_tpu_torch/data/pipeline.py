"""Host input pipeline: decode/augment worker threads and a prefetch to the
device that overlaps the host-to-device copy with compute.

Counterpart of ``mnasnet_tpu/data/pipeline.py``:

  * :class:`DataLoader` is a copy of the reference's: a thread pool decodes
    and augments two batches ahead of the consumer (PIL and libjpeg release
    the interpreter lock), augmentation draws from a generator keyed by
    ``(seed, epoch, index)``, so threads give the serial result, and the
    tail batch is padded to full size with label -1;
  * :func:`prefetch_to_device` is PyTorch's idiom for the reference's
    double-buffered ``jax.device_put``: a producer thread casts each batch
    on the host to the compute dtype, pins it and copies it on a side CUDA
    stream; the consumer's stream waits on the copy's event.
"""

from __future__ import annotations

import json
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from mnasnet_tpu_torch.data.dataset import shard_indices

# Debug hook: when set, every batch the loader yields is appended to this
# path as one JSON line {n, epoch, batch, indices, n_valid}. ``indices`` is
# the batch as yielded, so a padded tail includes its wrap-padding indices;
# ``n_valid`` is the count of real samples in a padded tail (null for a full
# batch), and consumers slice indices[:n_valid]. Off unless set.
_CONSUMED_LOG_ENV = "MNASNET_TPU_CONSUMED_LOG"


class DataLoader:
    """Iterates (images NHWC fp32, labels int32) host batches for one epoch.

    ``transform(img: PIL, rng) -> HWC float32`` (``transform(img)`` when
    ``augment=False``); rng is derived per (seed, epoch, index), so the
    augmentation does not depend on worker scheduling. ``bytes_transform``,
    when set and the dataset has ``load_bytes``, decodes raw JPEG bytes (the
    native decoder) and falls back to the PIL ``transform`` per image.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        transform: Callable,
        *,
        shuffle: bool = False,
        drop_last: bool = False,
        seed: int = 0,
        workers: int = 4,
        shard_id: int = 0,
        num_shards: int = 1,
        augment: bool = True,
        bytes_transform: Optional[Callable] = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.transform = transform
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._fallback_count = 0  # native-decoder -> PIL per-image fallbacks
        self._fallback_lock = threading.Lock()  # workers increment concurrently
        self.seed = seed
        self.workers = workers
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.augment = augment
        self.bytes_transform = bytes_transform

    @property
    def fallback_count(self) -> int:
        """Native-decoder -> PIL per-image fallbacks so far (exact; the
        warning only samples occurrences 1, 100 and multiples of 10k)."""
        with self._fallback_lock:
            return self._fallback_count

    def steps_per_epoch(self) -> int:
        n = len(self.dataset)
        per_shard = (n // self.num_shards) if self.drop_last else -(-n // self.num_shards)
        return (per_shard // self.batch_size if self.drop_last
                else -(-per_shard // self.batch_size))

    def _rng(self, epoch: int, index: int) -> np.random.Generator:
        return np.random.default_rng((self.seed, epoch, index))

    def _load_one(self, epoch: int, index: int):
        index = int(index)
        if self.bytes_transform is not None and hasattr(self.dataset, "load_bytes"):
            data, label = self.dataset.load_bytes(index)
            if data is not None:
                try:
                    if self.augment:
                        return self.bytes_transform(data, self._rng(epoch, index)), label
                    return self.bytes_transform(data), label
                except Exception as e:
                    # Per-image PIL fallback: the native decoder rejects JPEGs
                    # libjpeg cannot return as RGB (CMYK/YCCK); PIL converts
                    # them. Counted and sampled to the log, so that a decoder
                    # failing on every image is visible.
                    with self._fallback_lock:
                        self._fallback_count += 1
                        count = self._fallback_count
                    if count in (1, 100) or count % 10000 == 0:
                        print(f"warning: native decode failed ({type(e).__name__}: {e}); "
                              f"PIL fallback (occurrence #{count})", flush=True)
        img, label = self.dataset.load(index)
        if self.augment:
            return self.transform(img, self._rng(epoch, index)), label
        return self.transform(img), label

    def epoch(self, epoch: int = 0,
              start_step: int = 0) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """Yield the epoch's batches from batch index ``start_step`` on
        (mid-epoch resume: the skipped batches, those an interrupted run
        consumed in the same (seed, epoch)-keyed order, are never decoded)."""
        indices = shard_indices(
            len(self.dataset), epoch, shuffle=self.shuffle, seed=self.seed,
            shard_id=self.shard_id, num_shards=self.num_shards, drop_last=self.drop_last,
        )
        bs = self.batch_size
        n_full = len(indices) // bs
        ends = n_full * bs
        batches = [indices[i * bs:(i + 1) * bs] for i in range(n_full)]
        n_valid_tail = None
        if not self.drop_last and ends < len(indices):
            # Pad the tail batch by wrapping, so every batch has one shape;
            # padded positions get label -1, which loss and metrics mask.
            tail = indices[ends:]
            n_valid_tail = len(tail)
            pad = np.resize(indices[: max(1, ends)] if ends else tail, bs - len(tail))
            batches.append(np.concatenate([tail, pad]))

        last = len(batches) - 1

        def valid(bi: int) -> Optional[int]:
            return n_valid_tail if bi == last and n_valid_tail is not None else None

        if not 0 <= start_step <= len(batches):
            raise ValueError(f"start_step {start_step} out of range for an epoch of "
                             f"{len(batches)} batches")
        # Original batch indices, so the tail's masking holds wherever
        # iteration starts.
        todo = list(enumerate(batches))[start_step:]
        log_path = os.environ.get(_CONSUMED_LOG_ENV)

        def log_consumed(bi: int, batch_idx) -> None:
            if not log_path:
                return
            with open(log_path, "a") as f:
                f.write(json.dumps({
                    # the dataset's length tells loaders sharing one log apart
                    "n": len(self.dataset),
                    "epoch": epoch, "batch": bi,
                    "indices": [int(i) for i in batch_idx],
                    "n_valid": valid(bi),
                }) + "\n")

        if self.workers <= 0:
            for bi, batch_idx in todo:
                pairs = [self._load_one(epoch, i) for i in batch_idx]
                log_consumed(bi, batch_idx)
                yield self._collate(pairs, valid(bi))
            return

        with ThreadPoolExecutor(max_workers=self.workers) as pool:
            def submit(nb):
                return nb[0], [pool.submit(self._load_one, epoch, i) for i in nb[1]]

            # Two batches ahead of the consumer.
            it = iter(todo)
            pending = [submit(nb) for nb in (next(it, None), next(it, None)) if nb is not None]
            while pending:
                bi, futs = pending.pop(0)
                nb = next(it, None)
                if nb is not None:
                    pending.append(submit(nb))
                log_consumed(bi, batches[bi])
                yield self._collate([f.result() for f in futs], valid(bi))

    @staticmethod
    def _collate(pairs, n_valid: Optional[int] = None) -> tuple[np.ndarray, np.ndarray]:
        images = np.stack([p[0] for p in pairs]).astype(np.float32)
        labels = np.asarray([p[1] for p in pairs], dtype=np.int32)
        if n_valid is not None:
            labels[n_valid:] = -1  # padding sentinel, masked by loss/metrics
        return images, labels


class _Failure:
    """A producer-side exception, re-raised in the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


def prefetch_to_device(iterator: Iterator, *, device, dtype: torch.dtype | None = None,
                       size: int = 2) -> Iterator[tuple[torch.Tensor, torch.Tensor]]:
    """Wrap a host-batch iterator of (images, labels) numpy arrays so that
    the host-to-device copy overlaps compute; yields (images, labels)
    tensors on ``device``, images cast to ``dtype``.

    A producer thread keeps up to ``size`` batches ahead. It casts the images
    on the host (torch's CPU cast rounds to nearest even, as the reference's
    numpy cast before its transfer does; bf16 halves the bytes copied), and on
    a CUDA device pins both arrays and copies them with ``non_blocking=True``
    on a side stream, recording an event. The consumer's current stream waits
    on that event before the batch is yielded, and ``record_stream`` keeps the
    caching allocator from handing the batch's memory to the next copy while
    the consumer's stream may still read it. On a CPU device the cast is all.

    Loader exceptions are re-raised in the consumer, never swallowed as a
    short epoch, and a consumer that stops early (an exception, a break)
    stops the producer.
    """
    device = torch.device(device)
    q: queue.Queue = queue.Queue(maxsize=size)
    end = object()
    stop = threading.Event()
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def place(batch):
        images, labels = batch
        x = torch.from_numpy(np.ascontiguousarray(images))
        y = torch.from_numpy(np.ascontiguousarray(labels))
        if dtype is not None:
            x = x.to(dtype)
        if stream is None:
            return x.to(device), y.to(device), None
        x, y = x.pin_memory(), y.pin_memory()
        with torch.cuda.stream(stream):
            xd = x.to(device, non_blocking=True)
            yd = y.to(device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(stream)
        return xd, yd, ready

    def enqueue(item) -> bool:
        """Blocking put that gives up when the consumer has gone away."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for batch in iterator:
                if not enqueue(place(batch)):
                    return
        except BaseException as e:  # re-raised in the consumer
            enqueue(_Failure(e))
        else:
            enqueue(end)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                break
            if isinstance(item, _Failure):
                raise item.exc
            x, y, ready = item
            if ready is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(ready)
                x.record_stream(current)
                y.record_stream(current)
            yield x, y
    finally:
        stop.set()
        while True:  # drain, so that a blocked producer put() returns promptly
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join(timeout=10)
