"""End-to-end inference with the input path: JPEG bytes to logits on the card.

Counterpart of ``tools/e2e_infer.py``: mnasnet0_5 at 160 px, batch 256, bf16,
over a generated ImageNet-like JPEG tree (:func:`make_jpeg_tree`, the
reference's files byte for byte). The path is the port's own:
``data/dataset.py:ImageFolderDataset`` -> ``data/pipeline.py:DataLoader``
(the native decoder, or PIL per image) -> ``prefetch_to_device(device,
dtype=bf16)`` -> ``make_predict_fn`` on ``--route`` (default: one CUDA graph
per shape). For each decoder (``native-fast``, ``native``, ``pil``; a native
one that does not build here is reported and skipped) and each of
``--workers``: the end-to-end images/s of full passes (host clock, the last
logits synchronised), the loader's alone, ``host_bound`` (end to end under
half the device-only rate) and the loader's count of per-image PIL
fallbacks; each the median of ``--repeats`` passes after one untimed pass.
The device-only ceiling is the predict on resident data, CUDA events, the
median of ``--repeats`` windows.

    python -m mnasnet_tpu_torch.tools.e2e_infer [--n-images 2048] [--workers 1,2,4,8] \\
        [--out F.json]
    python -m mnasnet_tpu_torch.tools.e2e_infer --device cpu --arch mnasnet0_35 \\
        --image-size 32 --batch-size 4 --n-images 8 --workers 1 --decoders pil \\
        --route eager --out i.json

Runs on the card (``--device``, default cuda) and exits non-zero when the
device it is asked for is not there; with ``--device cpu`` the card's keys
(the device-only and end-to-end rates) are null.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from mnasnet_tpu_torch import create_model
from mnasnet_tpu_torch.data import native_decoder
from mnasnet_tpu_torch.data.dataset import ImageFolderDataset
from mnasnet_tpu_torch.data.pipeline import DataLoader, prefetch_to_device
from mnasnet_tpu_torch.data.transforms import eval_transform
from mnasnet_tpu_torch.tools.bench_latency import routed
from mnasnet_tpu_torch.train.steps import make_predict_fn
from mnasnet_tpu_torch.utils.card import card_info, interleaved_ms, median, open_device

DECODERS = ("native-fast", "native", "pil")


def make_jpeg_tree(root: str, n_images: int, n_classes: int = 8,
                   size=(500, 375), quality: int = 92) -> None:
    """ImageNet-like JPEG tree under ``root/val``: class dirs, 500x375 photos
    (the typical ImageNet resolution), the reference tool's files byte for
    byte."""
    from PIL import Image

    rng = np.random.default_rng(0)
    w, h = size
    for i in range(n_images):
        cls = i % n_classes
        d = os.path.join(root, "val", f"class_{cls:03d}")
        os.makedirs(d, exist_ok=True)
        base = rng.standard_normal((h // 25 + 1, w // 25 + 1, 3))
        img = np.kron(base, np.ones((25, 25, 1)))[:h, :w]
        img = ((img - img.min()) / (np.ptp(img) + 1e-9) * 255).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(d, f"img_{i:05d}.jpg"), quality=quality)


def make_loader(ds, decoder: str, workers: int, image: int, batch: int) -> DataLoader:
    bytes_tf = None
    if decoder != "pil":
        fast = decoder == "native-fast"

        def bytes_tf(data):
            return native_decoder.decode_eval(data, image, fast=fast)
    return DataLoader(ds, batch, lambda im: eval_transform(im, image), shuffle=False,
                      drop_last=True, workers=workers, augment=False, bytes_transform=bytes_tf)


def e2e_pass(loader: DataLoader, predict, device) -> float:
    """Images/s of one full pass: decode -> prefetch (bf16, to the device) ->
    predict, to the last logits."""
    n, last = 0, None
    t0 = time.perf_counter()
    for images, _ in prefetch_to_device(loader.epoch(0), device=device, dtype=torch.bfloat16):
        last = predict(images)
        n += images.shape[0]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if last is None:
        raise RuntimeError("the loader gave no batch: fewer images than one batch")
    return n / (time.perf_counter() - t0)


def loader_pass(loader: DataLoader) -> float:
    n = 0
    t0 = time.perf_counter()
    for images, _ in loader.epoch(0):
        n += images.shape[0]
    return n / (time.perf_counter() - t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mnasnet0_5")
    ap.add_argument("--image-size", type=int, default=160)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--n-images", type=int, default=2048)
    ap.add_argument("--workers", default="1,2,4,8")
    ap.add_argument("--decoders", default=",".join(DECODERS))
    ap.add_argument("--route", default="graph", help="the predict's route (utils/routing.py)")
    ap.add_argument("--repeats", type=int, default=5, help="timed passes of each row")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", type=Path, default=Path("build/e2e_infer.json"))
    args = ap.parse_args(argv)
    device = open_device(args.device, "e2e_infer")
    on_card = device.type == "cuda"
    img, bs = args.image_size, args.batch_size
    decoders = args.decoders.split(",")
    unknown = set(decoders) - set(DECODERS)
    if unknown:
        raise SystemExit(f"unknown decoders {sorted(unknown)}; choices: {DECODERS}")

    native = native_decoder.available()
    reason = None if native else native_decoder.unavailable_reason
    if not native and set(decoders) - {"pil"}:
        print(f"native decoder unavailable ({reason}); running the pil rows only", flush=True)
    model = create_model(args.arch, device=device, dtype=torch.bfloat16, seed=0)
    predict = routed(make_predict_fn(model), args.route, device)

    # The device-only ceiling on resident data.
    g = torch.Generator(device=device).manual_seed(1)
    x_dev = torch.randn(bs, img, img, 3, device=device, generator=g).to(torch.bfloat16)
    predict(x_dev)
    device_ms = median(interleaved_ms({"predict": lambda: predict(x_dev)}, args.repeats,
                                      200.0)["predict"]) if on_card else None
    device_ips = None if device_ms is None else bs / device_ms * 1e3
    print(f"device-only: {device_ips} images/s", flush=True)

    table = []
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        make_jpeg_tree(tmp, args.n_images)
        print(f"{args.n_images} JPEGs in {time.perf_counter() - t0:.1f} s", flush=True)
        ds = ImageFolderDataset(os.path.join(tmp, "val"))
        for decoder in decoders:
            if decoder != "pil" and not native:
                continue
            for workers in [int(w) for w in args.workers.split(",")]:
                loader = make_loader(ds, decoder, workers, img, bs)
                e2e_pass(loader, predict, device)  # warm: capture, page cache
                e2e = statistics.median(e2e_pass(loader, predict, device)
                                        for _ in range(args.repeats))
                host = statistics.median(loader_pass(loader) for _ in range(args.repeats))
                row = {"decoder": decoder, "workers": workers,
                       "e2e_ips": e2e if on_card else None, "loader_only_ips": host,
                       "host_bound": bool(e2e < 0.5 * device_ips) if on_card else None,
                       "fallback_count": loader.fallback_count}
                table.append(row)
                print(json.dumps(row), flush=True)

    timed = [r for r in table if r["e2e_ips"] is not None]
    best = max(timed, key=lambda r: r["e2e_ips"]) if timed else None

    def best_of(decoder):
        v = [r["e2e_ips"] for r in timed if r["decoder"] == decoder]
        return max(v) if v else None

    nf, pil = best_of("native-fast"), best_of("pil")
    out = {"tool": "e2e_infer", **card_info(device),
           "config": f"{args.arch}@{img} batch {bs} bf16 inference, JPEG tree "
                     f"({args.n_images} x 500x375 q92), {os.cpu_count()} host CPUs, "
                     f"predict on the {args.route} route",
           "native_decoder_available": native, "native_decoder_unavailable_reason": reason,
           "device_only_ips": device_ips, "table": table, "best": best,
           "native_fast_vs_pil_e2e": nf / pil if nf and pil else None,
           "method": f"median of {args.repeats} full passes after one untimed pass (host clock, "
                     "synchronised); device-only: CUDA events on resident data",
           "conclusion": None if best is None else
           (f"best {best['e2e_ips']:.1f} images/s end to end ({best['decoder']}, "
            f"workers={best['workers']}) against {device_ips:.1f} device-only: "
            + ("host-bound" if best["host_bound"] else "device-bound"))}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1) + "\n")
    print(json.dumps({k: out[k] for k in ("device_only_ips", "best", "conclusion")}))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
