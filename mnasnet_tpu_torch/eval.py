"""Evaluation CLI of the PyTorch port: the single-image request.

    python -m mnasnet_tpu_torch.eval --image cat.jpg --arch mnasnet1_0 --pretrained w.pth

The counterpart of the root ``eval.py``. Validating a DATA_DIR needs the
dataset, the loader and ``run_validation`` of the input-pipeline slice, and
``--resume`` the checkpoint slice; neither is ported yet, and the CLI says so
and exits non-zero.
"""

from __future__ import annotations

import argparse

import torch
from PIL import Image

from mnasnet_tpu_torch.data.transforms import eval_transform
from mnasnet_tpu_torch.pretrained import load_pretrained
from mnasnet_tpu_torch.train.steps import make_predict_fn

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def main(argv=None):
    p = argparse.ArgumentParser(description="MNASNet evaluation (PyTorch port)")
    p.add_argument("data", nargs="?", default=None)
    p.add_argument("-a", "--arch", default="mnasnet1_0")
    p.add_argument("--pretrained", default="", help="torchvision-layout .pth/.pt/.npz")
    p.add_argument("--resume", default="", help="checkpoint dir (not ported yet)")
    p.add_argument("--image", default="", help="classify a single image")
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--dtype", choices=sorted(_DTYPES), default="float32")
    p.add_argument("--fused-kernels", choices=["auto", "kernel", "torch"], default="auto")
    p.add_argument("--topk", type=int, default=5)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    if args.resume:
        raise SystemExit("--resume needs the checkpoint slice, which is not ported yet")
    if not args.image:
        raise SystemExit("validating a DATA_DIR needs the input-pipeline slice, which is "
                         "not ported yet; pass --image")
    if not args.pretrained:
        raise SystemExit("need --pretrained")

    model = load_pretrained(args.arch, args.pretrained, device=args.device,
                            dtype=_DTYPES[args.dtype], dw_impl=args.fused_kernels)
    x = eval_transform(Image.open(args.image), args.image_size)
    logits = make_predict_fn(model)(x[None])
    probs = torch.softmax(logits, dim=-1)[0].cpu()
    top = torch.topk(probs, min(args.topk, probs.numel()))
    for prob, i in zip(top.values.tolist(), top.indices.tolist()):
        print(f"class {i}: {prob:.4f}")


if __name__ == "__main__":
    main()
