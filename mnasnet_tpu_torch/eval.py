"""Evaluation CLI of the PyTorch port: the root ``eval.py``.

    python -m mnasnet_tpu_torch.eval DATA_DIR --arch mnasnet1_0 --pretrained w.pth
    python -m mnasnet_tpu_torch.eval DATA_DIR --resume CKPT_DIR [--best] [--use-ema]
    python -m mnasnet_tpu_torch.eval --image cat.jpg --arch mnasnet1_0 --pretrained w.pth

A DATA_DIR (its ``val/``, or the directory itself when it has none) goes
through the port's ``DataLoader`` and ``run_validation``: exact top-1/top-5
over the real samples of a padded tail. ``--resume`` reads the model's
weights from a training checkpoint without rebuilding its optimizer. JPEGs
are decoded as the train CLI's validation decodes them (``--decoder``,
default ``native-fast``), so a checkpoint scores here what the trainer
printed for it. Launched by ``torchrun`` on several processes, each scores
its shard of DATA_DIR at ``--batch-size / world`` and rank 0 prints the
counts summed over all shards, as the root ``eval.py:100-125`` does. Each
batch size runs on the route measured fastest for it on the card (eager, a
CUDA graph or ``torch.compile``: ``utils/routing.py``), as the root
``eval.py:121`` routes its eval step; ``--compilation-cache DIR`` keeps the
compiled route's caches across runs.
"""

from __future__ import annotations

import argparse
import os

import torch
from PIL import Image

from mnasnet_tpu_torch.data.transforms import eval_transform
from mnasnet_tpu_torch.models.mnasnet import create_model
from mnasnet_tpu_torch.ops.depthwise import CLI_IMPLS
from mnasnet_tpu_torch.pretrained import load_state_dict_file, load_weights
from mnasnet_tpu_torch.train.steps import make_eval_step, make_predict_fn
from mnasnet_tpu_torch.utils.compilation_cache import enable_compilation_cache
from mnasnet_tpu_torch.utils.routing import BatchRouted

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m mnasnet_tpu_torch.eval",
                                description="MNASNet evaluation (PyTorch port)")
    p.add_argument("data", nargs="?", default=None)
    p.add_argument("-a", "--arch", default="mnasnet1_0")
    p.add_argument("--pretrained", default="", help="torchvision-layout .pth/.pt/.npz")
    p.add_argument("--resume", default="", help="training checkpoint dir")
    p.add_argument("--use-ema", action="store_true",
                   help="with --resume: score the --model-ema weight moving average stored "
                        "in the checkpoint instead of the raw weights")
    p.add_argument("--best", action="store_true",
                   help="with --resume: load the best-acc1 checkpoint instead of the latest")
    p.add_argument("--image", default="", help="classify a single image")
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("-b", "--batch-size", type=int, default=256)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--decoder", choices=["pil", "native", "native-fast"],
                   default="native-fast",
                   help="JPEG path of DATA_DIR, as the train CLI's --decoder")
    p.add_argument("--dtype", choices=sorted(_DTYPES), default="float32")
    p.add_argument("--fused-kernels", choices=sorted(CLI_IMPLS), default="auto")
    p.add_argument("--topk", type=int, default=5)
    p.add_argument("--device", default="cuda")
    p.add_argument("--compilation-cache", default=None, metavar="DIR",
                   help="persistent cache of the compiled route (Inductor's FX graphs, "
                        "Triton's kernels) in DIR (default: $MNASNET_TPU_COMPILATION_CACHE, "
                        "else off)")
    args = p.parse_args(argv)
    enable_compilation_cache(args.compilation_cache)

    if args.use_ema and not args.resume:
        raise SystemExit("--use-ema requires --resume (the EMA shadow lives in the "
                         "checkpoint's optimizer state)")
    if args.resume:
        from mnasnet_tpu_torch.train.checkpoint import CheckpointManager

        sd, _, _ = CheckpointManager(os.path.abspath(args.resume), track_best=args.best) \
            .restore_variables(best=args.best, use_ema=args.use_ema)
    elif args.pretrained:
        sd = load_state_dict_file(args.pretrained)
    else:
        raise SystemExit("need --pretrained or --resume")
    model = create_model(args.arch, device=args.device,
                         num_classes=sd["classifier.1.weight"].shape[0],
                         dtype=_DTYPES[args.dtype], dw_impl=CLI_IMPLS[args.fused_kernels])
    load_weights(model, sd)

    if args.image:
        x = eval_transform(Image.open(args.image), args.image_size)
        logits = make_predict_fn(model)(x[None])
        probs = torch.softmax(logits, dim=-1)[0].cpu()
        top = torch.topk(probs, min(args.topk, probs.numel()))
        for prob, i in zip(top.values.tolist(), top.indices.tolist()):
            print(f"class {i}: {prob:.4f}")
        return

    if not args.data:
        raise SystemExit("DATA_DIR or --image required")

    from mnasnet_tpu_torch.data.dataset import ImageFolderDataset
    from mnasnet_tpu_torch.data.pipeline import DataLoader
    from mnasnet_tpu_torch.parallel import close, init_distributed
    from mnasnet_tpu_torch.train.trainer import run_validation

    bytes_tf = None
    if args.decoder != "pil":
        from mnasnet_tpu_torch.data import native_decoder

        if native_decoder.available():
            fast = args.decoder == "native-fast"

            def bytes_tf(data):
                return native_decoder.decode_eval(data, args.image_size, fast=fast)
        else:
            print("warning: native decoder unavailable, using PIL "
                  f"({native_decoder.unavailable_reason})", flush=True)
    val_root = os.path.join(args.data, "val")
    ds = ImageFolderDataset(val_root if os.path.isdir(val_root) else args.data)
    # torchrun's processes each score a shard; one process scores it all.
    replicas = init_distributed(device=args.device)
    try:
        world, rank = (1, 0) if replicas is None else (replicas.world, replicas.rank)
        if replicas is not None:
            model.to(replicas.device)
        loader = DataLoader(ds, args.batch_size // world,
                            lambda img: eval_transform(img, args.image_size), shuffle=False,
                            drop_last=False, workers=args.workers, augment=False,
                            shard_id=rank, num_shards=world, bytes_transform=bytes_tf)
        # Eval only: no Trainer, no optimizer, no TrainState.
        device = next(model.parameters()).device
        run_validation(BatchRouted(make_eval_step(model), batch_arg=0, device=device), loader,
                       device=device, compute_dtype=_DTYPES[args.dtype], verbose=rank == 0,
                       replicas=replicas)
    finally:
        close(replicas)


if __name__ == "__main__":
    main()
