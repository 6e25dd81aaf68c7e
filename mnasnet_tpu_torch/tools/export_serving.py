"""Serving export: model and weights -> one ``torch.export`` artifact.

Counterpart of ``tools/export_serving.py``. The eval-mode forward is traced
once with ``torch.export``, the trained weights carried in the program, and
saved to one file that :func:`mnasnet_tpu_torch.serving.load_serving`
reloads and serves without building the model. With ``--symbolic-batch``
the leading dimension is ``Dim("b")``: one artifact serves any batch size.

    python -m mnasnet_tpu_torch.tools.export_serving --arch mnasnet1_0 \\
        --resume RUN_DIR --dtype bfloat16 --symbolic-batch --out model.pt2
    python -m mnasnet_tpu_torch.tools.export_serving --verify model.pt2 \\
        --arch mnasnet1_0 --resume RUN_DIR   # reload, run, compare with the live forward

The call contract is ``f(images) -> float32 logits`` with images ``float32
[b, size, size, 3]`` already normalized, or ``uint8`` RGB with
``--raw-input``, where ``/255`` and the mean/std normalize run in fp32 inside
the artifact. Unlike the reference's StableHLO file, which carries its
Mosaic kernels inside, this artifact calls the port's kernels as the ops
``mnasnet_tpu_torch::dw_conv_bn_act`` and ``mnasnet_tpu_torch::mbconv_block``:
loading it needs the port installed (``load_serving`` imports the op
registrations), and running it on the card builds the kernel sources.

``--fused-kernels kernel`` (the default) records those ops whatever the
device it is traced on; ``torch`` records the plain PyTorch route. (The
model's ``"auto"`` resolves at trace time, so it would bake the torch route
into an artifact traced on the CPU.) ``--device`` is where the trace runs;
``load_serving`` moves the program to the device it serves on.
"""

from __future__ import annotations

import argparse
import io
import os
import sys

import torch
from torch import nn

from mnasnet_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from mnasnet_tpu_torch.models.mnasnet import create_model
from mnasnet_tpu_torch.ops.depthwise import CLI_IMPLS
from mnasnet_tpu_torch.pretrained import load_state_dict_file, load_weights

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class ServingForward(nn.Module):
    """The artifact's forward: NHWC images (normalized fp32, or uint8 with
    ``raw_input``) -> fp32 logits, whatever the compute dtype."""

    def __init__(self, model: nn.Module, raw_input: bool):
        super().__init__()
        self.model = model
        self.raw_input = raw_input
        self.register_buffer("mean", torch.from_numpy(IMAGENET_MEAN.copy()))
        self.register_buffer("std", torch.from_numpy(IMAGENET_STD.copy()))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        if self.raw_input:
            images = (images.float() / 255.0 - self.mean) / self.std
        return self.model(images.permute(0, 3, 1, 2)).float()


def build_forward(arch: str, num_classes: int, dtype_name: str, weights: dict | None,
                  image_size: int, batch_size: int, dw_impl: str = "kernel",
                  raw_input: bool = False, device="cuda", seed: int = 0):
    """(the eval-mode forward module with ``weights`` in it, an example input).

    ``weights`` is a torchvision-layout state_dict, or None for the seeded
    init (``seed``, smoke tests and benchmarks only). The parameters are
    frozen: the artifact is inference-only. ``raw_input=True`` makes the
    input uint8 [b, H, W, 3] RGB 0-255 and puts ``/255`` and the torchvision
    normalize (``transforms.normalize``'s fp32 arithmetic) in the forward."""
    model = create_model(arch, device="cpu", num_classes=num_classes,
                         dtype=_DTYPES[dtype_name], dw_impl=dw_impl, seed=seed)
    if weights is not None:
        load_weights(model, weights)
    fwd = ServingForward(model, raw_input).to(device).eval().requires_grad_(False)
    dtype = torch.uint8 if raw_input else torch.float32
    x = torch.zeros((batch_size, image_size, image_size, 3), dtype=dtype, device=device)
    return fwd, x


def load_weights_from_args(args) -> dict | None:
    """The state_dict named by ``--random-init``, ``--pretrained`` or
    ``--resume`` (with ``--best`` and ``--use-ema``)."""
    if args.random_init:
        return None
    if args.pretrained:
        return load_state_dict_file(args.pretrained)
    if args.resume:
        from mnasnet_tpu_torch.train.checkpoint import CheckpointManager

        sd, _, _ = CheckpointManager(os.path.abspath(args.resume), track_best=args.best) \
            .restore_variables(best=args.best, use_ema=args.use_ema)
        return sd
    raise SystemExit("need --resume, --pretrained, or --random-init")


def export_artifact(fn: nn.Module, x: torch.Tensor, symbolic_batch: bool = False) -> bytes:
    """``torch.export`` of ``fn`` at ``x``, saved into bytes. With
    ``symbolic_batch`` the leading dimension is ``Dim("b")``, so one artifact
    serves any batch size. The artifact keeps its example input, so a
    symbolic batch is traced on 2 images of ``x``'s shape (export
    specializes a dimension of size 1)."""
    dynamic = None
    if symbolic_batch:
        x = x.new_zeros((2, *x.shape[1:]))
        dynamic = ({0: torch.export.Dim("b")},)
    program = torch.export.export(fn, (x,), dynamic_shapes=dynamic)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def verify(path: str, fn: nn.Module, x: torch.Tensor, device) -> float:
    """max |artifact - live forward| on seeded inputs of ``x``'s shape and
    dtype, the artifact served through ``load_serving``'s eager route."""
    import numpy as np

    from mnasnet_tpu_torch.serving import load_serving

    predict = load_serving(path, route="eager", device=device)
    rng = np.random.default_rng(0)
    if x.dtype == torch.uint8:
        img = torch.from_numpy(rng.integers(0, 256, tuple(x.shape), dtype=np.uint8))
    else:
        img = torch.from_numpy(rng.standard_normal(tuple(x.shape), dtype=np.float32))
    img = img.to(x.device)
    got = predict(img)
    with torch.no_grad():
        want = fn(img)
    return float((got - want).abs().max())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m mnasnet_tpu_torch.tools.export_serving",
                                description=__doc__.split("\n")[0])
    p.add_argument("-a", "--arch", default="mnasnet1_0")
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--resume", default="", help="training checkpoint dir")
    p.add_argument("--pretrained", default="", help="torchvision-layout .pth/.pt/.npz")
    p.add_argument("--random-init", action="store_true",
                   help="export the seeded init weights (smoke tests and benchmarks only)")
    p.add_argument("--use-ema", action="store_true",
                   help="with --resume: export the --model-ema weight moving average")
    p.add_argument("--best", action="store_true",
                   help="with --resume: export the best-acc1 checkpoint, not the latest")
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("-b", "--batch-size", type=int, default=8)
    p.add_argument("--dtype", choices=sorted(_DTYPES), default="bfloat16")
    p.add_argument("--fused-kernels", choices=sorted(CLI_IMPLS), default="kernel",
                   help="kernel (default): the artifact calls the port's kernel ops; "
                        "torch: plain PyTorch ops; auto resolves on the trace's device")
    p.add_argument("--symbolic-batch", action="store_true",
                   help="export with a symbolic leading dim: one artifact serves any batch "
                        "size (-b then only sizes the --verify replay)")
    p.add_argument("--raw-input", action="store_true",
                   help="bake the torchvision normalize into the artifact: input becomes "
                        "uint8 RGB 0-255; /255 and mean/std run in fp32 inside it")
    p.add_argument("--device", default="cuda",
                   help="device of the trace and of --verify (default cuda; cpu runs the "
                        "kernels' plain versions)")
    p.add_argument("--out", default="model.pt2")
    p.add_argument("--verify", default="", metavar="ARTIFACT",
                   help="instead of exporting: load ARTIFACT, run it, and compare it with "
                        "the live forward")
    args = p.parse_args(argv)
    if args.use_ema and not args.resume:
        raise SystemExit("--use-ema requires --resume")

    weights = load_weights_from_args(args)
    fn, x = build_forward(args.arch, args.num_classes, args.dtype, weights, args.image_size,
                          args.batch_size, dw_impl=CLI_IMPLS[args.fused_kernels],
                          raw_input=args.raw_input, device=args.device)
    if args.verify:
        diff = verify(args.verify, fn, x, args.device)
        print(f"max |artifact - live| = {diff:.3e} at {tuple(x.shape)} {x.dtype}")
        if diff > 1e-5:
            raise SystemExit(f"verify FAILED: diff {diff}")
        print("verify OK")
        return 0
    data = export_artifact(fn, x, symbolic_batch=args.symbolic_batch)
    with open(args.out, "wb") as f:
        f.write(data)
    b = "b" if args.symbolic_batch else str(args.batch_size)
    in_ty = "uint8" if args.raw_input else "float32"
    print(f"wrote {args.out}: {len(data) / 1e6:.2f} MB, call: f({in_ty}[{b},"
          f"{args.image_size},{args.image_size},3]) -> float32 logits; needs the "
          "mnasnet_tpu_torch ops at load time")
    return 0


if __name__ == "__main__":
    sys.exit(main())
