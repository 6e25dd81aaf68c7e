"""The depth-multiplier x resolution grid on the card.

Counterpart of ``tools/sweep_grid.py`` (the NAS-style eval grid, alpha
0.35-1.4, 96-224 px). For each grid point, at ``--batch-size`` in bf16:

  * parameters and MACs (``models/mnasnet.py:count_macs``);
  * the serving forward (``make_predict_fn``, seeded weights) of each of
    ``IMPLS`` (``dw_impl`` kernel and torch) on ``--route`` (default one
    CUDA graph per shape): images/s, the impls timed in turns with CUDA
    events, the median of ``--repeats`` windows; the fused MBConv blocks and
    dw launches per forward, counted on an eager call;
  * the shapes a planner refuses at this point (``ops/cuda/dw_conv.py:plan``
    for each depthwise conv, ``ops/cuda/mbconv.py:mbconv_fits_smem`` for each
    block, ``ops/cuda/bn_bwd.py:reduce_plan`` for each BN+ReLU region of the
    training forward): those shapes fall back to the torch route;
  * with ``--train``, the production train step's images/s and peak memory
    on ``TRAIN_ROUTE`` for each impl (``tools/train_variants.py:time_train``,
    ``dw_impl`` and ``bn_bwd`` both the impl).

    python -m mnasnet_tpu_torch.tools.sweep_grid [--alphas 0.35,0.5,0.75,1.0,1.3,1.4] \\
        [--sizes 96,160,224] [--train] [--out F.json]
    python -m mnasnet_tpu_torch.tools.sweep_grid --device cpu --alphas 0.35 --sizes 32 \\
        --batch-size 2 --route eager --out g.json

Runs on the card (``--device``, default cuda) and exits non-zero when the
device it is asked for is not there; with ``--device cpu`` each forward runs
once and the card's keys (rates, launches, memory) are null.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from mnasnet_tpu_torch import create_model
from mnasnet_tpu_torch.models.mnasnet import count_macs
from mnasnet_tpu_torch.ops.cuda import bn_bwd, dw_conv, mbconv
from mnasnet_tpu_torch.tools.bench_latency import IMPLS, launches_of, routed
from mnasnet_tpu_torch.tools.memory_probe import PRODUCTION
from mnasnet_tpu_torch.tools.train_variants import time_train, train_batch
from mnasnet_tpu_torch.tools.tune_plans import block_shapes, bn_region_shapes, dw_shapes
from mnasnet_tpu_torch.train.steps import make_predict_fn
from mnasnet_tpu_torch.utils.card import card_info, interleaved_ms, median, open_device
from mnasnet_tpu_torch.utils.routing import TRAIN_ROUTE

BF16_BYTES = 2


def arch_name(alpha: float) -> str:
    whole, frac = str(float(alpha)).split(".")
    return f"mnasnet{whole}_{frac}"


def refused_shapes(alpha: float, image: int, batch: int) -> list[dict]:
    """The shapes whose planner has no launch at this point, in bf16."""
    out = []
    for h, c, k, s in dw_shapes(alpha, image):
        try:
            dw_conv.plan(batch, h, h, c, k, s, BF16_BYTES)
        except ValueError as e:
            out.append({"planner": "dw_conv.plan", "shape": [batch, h, h, c, k, s],
                        "why": str(e)})
    for name, h, cin, cmid, cout, k, s in block_shapes(alpha, image):
        if not mbconv.mbconv_fits_smem(h, h, cin, cmid, cout, k, s, BF16_BYTES):
            out.append({"planner": "mbconv_fits_smem", "block": name,
                        "shape": [h, h, cin, cmid, cout, k, s]})
    for name, h, c in bn_region_shapes(alpha, image):
        try:
            bn_bwd.reduce_plan(batch * h * h, c, BF16_BYTES)
        except ValueError as e:
            out.append({"planner": "bn_bwd.reduce_plan", "region": name,
                        "shape": [batch * h * h, c], "why": str(e)})
    return out


def serving(alpha: float, image: int, batch: int, route: str, repeats: int,
            target_ms: float, device) -> dict:
    on_card = device.type == "cuda"
    arch = arch_name(alpha)
    predict = {impl: make_predict_fn(create_model(arch, device=device, dtype=torch.bfloat16,
                                                  dw_impl=impl, seed=0)) for impl in IMPLS}
    served = {impl: routed(fn, route, device) for impl, fn in predict.items()}
    x = torch.randn(batch, image, image, 3, device=device,
                    generator=torch.Generator(device=device).manual_seed(1))
    out = {"launches_per_forward": {impl: launches_of(fn, x, on_card)
                                    for impl, fn in predict.items()}}
    for fn in served.values():
        fn(x)  # warm-up, and a graph's capture
    times = interleaved_ms({impl: (lambda f=fn: f(x)) for impl, fn in served.items()},
                           repeats, target_ms) if on_card else {}
    for impl in IMPLS:
        ms = median(times.get(impl))
        out[f"infer_{impl}_ms"] = ms
        out[f"infer_{impl}_ips"] = None if ms is None else batch / ms * 1e3
    kernel = out["launches_per_forward"].get("kernel")
    out["fused_mbconv_blocks"] = None if kernel is None else kernel["mbconv_block"]
    out["dw_launches"] = None if kernel is None else kernel["dw_conv_bn_act"]
    return out


def training(alpha: float, image: int, batch: int, repeats: int, target_ms: float,
             device) -> dict:
    out = {}
    images, labels = train_batch(batch, device, image=image)
    for impl in IMPLS:
        row = time_train({**PRODUCTION, "dw_impl": impl, "bn_bwd": impl}, TRAIN_ROUTE,
                         images, labels, target_ms=target_ms, arch=arch_name(alpha),
                         repeats=repeats)
        out[f"train_{impl}_ms"] = row["ms_per_step"]
        out[f"train_{impl}_ips"] = row["images_per_s"]
        out[f"train_{impl}_peak_allocated_gb"] = row["peak_allocated_gb"]
        out[f"train_{impl}_launches_per_step"] = row["launches_per_step"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--alphas", default="0.35,0.5,0.75,1.0,1.3,1.4")
    ap.add_argument("--sizes", default="96,160,224")
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--route", default="graph", help="the serving forward's route")
    ap.add_argument("--train", action="store_true", help="also time the train step")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--target-ms", type=float, default=100.0, help="length of one window")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", type=Path, default=Path("build/sweep_grid.json"))
    args = ap.parse_args(argv)
    device = open_device(args.device, "sweep_grid")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bs = args.batch_size
    rows = []
    for alpha in [float(a) for a in args.alphas.split(",")]:
        for size in [int(s) for s in args.sizes.split(",")]:
            arch = arch_name(alpha)
            n_params = sum(p.numel() for p in create_model(arch, device="cpu").parameters())
            row = {"alpha": alpha, "image_size": size, "arch": arch, "params": n_params,
                   "macs": count_macs(alpha, size),
                   "refused": refused_shapes(alpha, size, bs),
                   **serving(alpha, size, bs, args.route, args.repeats,
                             args.target_ms, device)}
            if args.train:
                row.update(training(alpha, size, bs, args.repeats,
                                    args.target_ms * 3, device)
                           if device.type == "cuda" else
                           {f"train_{impl}_{k}": None for impl in IMPLS
                            for k in ("ms", "ips", "peak_allocated_gb", "launches_per_step")})
            if device.type == "cuda":
                torch.cuda.empty_cache()
            rows.append(row)
            print(json.dumps(row), flush=True)

    slower = [(r["alpha"], r["image_size"]) for r in rows
              if r.get("infer_kernel_ms") and r.get("infer_torch_ms")
              and r["infer_kernel_ms"] > r["infer_torch_ms"]]
    out = {"tool": "sweep_grid", **card_info(device), "batch_size": bs, "dtype": "bfloat16",
           "route": args.route, "impls": IMPLS,
           "method": f"make_predict_fn per impl on the {args.route} route; CUDA events, the "
                     f"impls in turns, median of {args.repeats} windows; --train: time_train "
                     "on TRAIN_ROUTE",
           "rows": rows,
           "kernel_slower_than_torch_at": slower if device.type == "cuda" else None}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1) + "\n")
    print(f"\n{'alpha':>6} {'size':>5} {'params':>10} {'MMACs':>8} "
          + " ".join(f"{impl + ' img/s':>13}" for impl in IMPLS))
    for r in rows:
        print(f"{r['alpha']:>6} {r['image_size']:>5} {r['params']:>10,} {r['macs'] / 1e6:>8.1f} "
              + " ".join(f"{r[f'infer_{impl}_ips'] or 0:>13,.0f}" for impl in IMPLS))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
