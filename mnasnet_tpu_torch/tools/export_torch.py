"""Export a training checkpoint of the port to a torchvision-layout ``.pth``.

Counterpart of ``tools/export_torch.py``. The port's model already has
torchvision's parameter names, so the export is the selection: the latest or
the best checkpoint (``--best``), the raw weights or the ``--model-ema``
moving average (``--use-ema``, the TF recipe's serving weights). The file
loads with a strict ``load_state_dict`` into torchvision's ``mnasnet*``
constructors and into the port's model.

    python -m mnasnet_tpu_torch.tools.export_torch --resume RUN_DIR \\
        --arch mnasnet1_0 --out model.pth [--best] [--use-ema]
"""

from __future__ import annotations

import argparse
import os

import torch

from mnasnet_tpu_torch.convert.torch_converter import check_state_dict
from mnasnet_tpu_torch.models.mnasnet import arch_alpha
from mnasnet_tpu_torch.train.checkpoint import CheckpointManager


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m mnasnet_tpu_torch.tools.export_torch",
                                description=__doc__.split("\n")[0])
    p.add_argument("--resume", required=True, help="training checkpoint dir")
    p.add_argument("-a", "--arch", default="mnasnet1_0")
    p.add_argument("--out", required=True, help="output .pth path")
    p.add_argument("--best", action="store_true", help="export the best-acc1 checkpoint")
    p.add_argument("--use-ema", action="store_true",
                   help="export the --model-ema weight moving average")
    args = p.parse_args(argv)

    sd, epoch, best_acc1 = CheckpointManager(os.path.abspath(args.resume),
                                             track_best=args.best) \
        .restore_variables(best=args.best, use_ema=args.use_ema)
    sd = {k: v.detach().cpu().contiguous() for k, v in sd.items()}
    check_state_dict(sd, arch_alpha(args.arch))
    torch.save({"state_dict": sd, "arch": args.arch, "epoch": epoch,
                "best_acc1": best_acc1}, args.out)
    n = sum(v.numel() for v in sd.values())
    print(f"wrote {args.out}: {len(sd)} tensors, {n:,} scalars "
          f"(epoch {epoch}, best_acc1 {best_acc1:.3f}"
          f"{', EMA weights' if args.use_ema else ''})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
