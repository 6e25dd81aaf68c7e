"""ImageNet-layout dress rehearsal of the port's CLIs: the counterpart of
``tools/dress_rehearsal.py``.

    python -m mnasnet_tpu_torch.tools.dress_rehearsal [--n-classes 1000] [--image-size 64]
        [--batch-size 32] [--device cuda] [--out build/dress_rehearsal.json]

On the card unless ``--device cpu``.

A generated on-disk JPEG tree of ``--n-classes`` class directories (names
whose sorted order differs from their creation order, two train and one val
image a class, and one CMYK JPEG that the native decoder refuses) goes
through one epoch of ``python -m mnasnet_tpu_torch.train`` with the
``native-fast`` decoder, then ``python -m mnasnet_tpu_torch.eval --resume``.
It holds:
  * the decoder's per-image fallback to PIL fires exactly once (the CMYK
    file), from the exact count the train CLI prints;
  * the class-to-label mapping is lexicographic and the same for two
    instances of the dataset;
  * the epoch completes with a checkpoint, and the eval CLI restores it and
    scores the val tree.
Writes a JSON with the reference's keys and exits 1 when it is not ok. The
native decoder must be available (``data/native_decoder.py``): without it
every image goes through PIL and the fallback cannot fire.
"""

from __future__ import annotations

import argparse
import os
import re
import tempfile
import time
from pathlib import Path

import numpy as np

from mnasnet_tpu_torch.tools import multihost


def make_tree(root, n_classes: int = 1000, per_class_train: int = 2, per_class_val: int = 1,
              size=(120, 96)) -> dict:
    """``root/{train,val}/<class>/im<j>.jpg``: random pixels at ``size``
    (w, h) from seed 0, class names whose sorted order is not their creation
    order, and one CMYK JPEG in the first sorted train class."""
    from PIL import Image

    rng = np.random.default_rng(0)
    w, h = size
    names = [f"{'nc'[i % 2]}{i:04d}_{rng.integers(0, 10)}" for i in range(n_classes)]
    counts = {"train": 0, "val": 0}
    for split, per in (("train", per_class_train), ("val", per_class_val)):
        for name in names:
            d = os.path.join(root, split, name)
            os.makedirs(d, exist_ok=True)
            for j in range(per):
                arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                Image.fromarray(arr).save(os.path.join(d, f"im{j}.jpg"), quality=80)
                counts[split] += 1
    cmyk_path = os.path.join(root, "train", sorted(names)[0], "im_cmyk.jpg")
    Image.new("CMYK", (w, h), (10, 200, 30, 5)).save(cmyk_path)
    counts["train"] += 1
    return {"names": names, "counts": counts, "cmyk_path": cmyk_path}


def fallbacks(text: str) -> int:
    """The last exact decoder-fallback count a rank printed (0 if none)."""
    m = re.findall(r"decoder-fallbacks: (\d+) ", text)
    return int(m[-1]) if m else 0


def rehearse(work, n_classes: int, image_size: int, batch_size: int, workers: int = 4,
             timeout: float = 3600.0, device: str = "cpu") -> dict:
    from mnasnet_tpu_torch.data import native_decoder
    from mnasnet_tpu_torch.data.dataset import ImageFolderDataset

    if not native_decoder.available():
        raise SystemExit("the native decoder is unavailable "
                         f"({native_decoder.unavailable_reason}): the fallback cannot fire")
    work = Path(work).resolve()  # the children run in the repository root
    data, ckpt = work / "data", work / "ckpt"
    t0 = time.perf_counter()
    info = make_tree(data, n_classes)
    gen_s = time.perf_counter() - t0
    a, b = (ImageFolderDataset(str(data / "train")) for _ in range(2))
    mapping_ok = (a.class_to_idx == b.class_to_idx and a.classes == sorted(info["names"])
                  and len(a.classes) == n_classes)

    t0 = time.perf_counter()
    text = multihost.run_one(
        [str(data), "--arch", "mnasnet0_5", "--image-size", str(image_size), "--batch-size",
         str(batch_size), "--workers", str(workers), "--decoder", "native-fast",
         "--num-classes", str(n_classes), "--print-freq", "20", "--seed", "0", "--epochs", "1",
         "--output-dir", str(ckpt)], work / "train.log", timeout, device)
    train_s = time.perf_counter() - t0
    fb = fallbacks(text)
    eval_text = multihost.run_one(
        [str(data), "--arch", "mnasnet0_5", "--image-size", str(image_size), "-b",
         str(batch_size), "--workers", str(workers), "--resume", str(ckpt)],
        work / "eval.log", timeout, device, module="mnasnet_tpu_torch.eval")
    epoch_done = "epoch 0:" in text and (ckpt / "0").is_dir()
    scored = "Acc@1" in eval_text
    return {
        "ok": bool(epoch_done and fb == 1 and mapping_ok and scored),
        "n_classes": n_classes,
        "device": device,
        "images": info["counts"],
        "decoder_fallback_count": fb,
        "cmyk_fallback_fired_exactly_once": fb == 1,
        "label_mapping_lexicographic_and_stable": mapping_ok,
        "train_epoch_completed": epoch_done,
        "eval_resume_scored": scored,
        "gen_seconds": round(gen_s, 1),
        "train_seconds": round(train_s, 1),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(multihost.REPO / "build" / "dress_rehearsal.json"))
    ap.add_argument("--n-classes", type=int, default=1000)
    ap.add_argument("--image-size", type=int, default=64)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--keep", default=None, help="keep the tree and the logs here")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    multihost.exit_on_sigterm()
    device, _ = multihost.layout(args.device, 1, "dress_rehearsal")
    with tempfile.TemporaryDirectory() as tmp:
        out = rehearse(args.keep or tmp, args.n_classes, args.image_size, args.batch_size,
                       device=device)
    return multihost.finish(out, args.out)


if __name__ == "__main__":
    raise SystemExit(main())
