"""Serving latency by batch size: the fused kernels against the torch route.

Counterpart of ``tools/bench_latency.py``, which raced the reference's
``dw_impl`` values ``auto`` (XLA) and ``pallas`` at batch 1 to 128; here
``IMPLS`` (kernel, torch) are the port's names for ``pallas,auto``. For each
batch size and each impl, ``make_predict_fn`` of the live bf16 model
(seeded weights) runs on each of ``--routes`` (``utils/routing.py``:
``eager``, one CUDA ``graph`` per shape), all of them timed in turns with
CUDA events after warm-up, as the median of ``--repeats`` windows
(``utils/card.py:interleaved_ms``). A row gives ms per batch and images/s of
each impl on each route, each impl's fastest route, the kernel route's
speed-up over the torch route, the kernels' launches per forward (counted on
an eager call: 1 dw and 16 MBConv for mnasnet1_0 on the kernel route), and
whether the kernel route's fastest route at that size is the one
``SERVE_ROUTE_BATCH_RANGES`` gives it.

    python -m mnasnet_tpu_torch.tools.bench_latency [--arch mnasnet1_0] \\
        [--batches 1,2,4,8,16,32,64,128] [--routes eager,graph] [--out F.json]
    python -m mnasnet_tpu_torch.tools.bench_latency --device cpu --arch mnasnet0_35 \\
        --image-size 32 --batches 1,2 --routes eager --out b.json

Runs on the card (``--device``, default cuda) and exits non-zero when the
device it is asked for is not there; with ``--device cpu`` each forward runs
once and the card's keys (times, launches) are null.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from mnasnet_tpu_torch import create_model
from mnasnet_tpu_torch.tools.train_variants import counts
from mnasnet_tpu_torch.train.steps import make_predict_fn
from mnasnet_tpu_torch.utils.card import card_info, interleaved_ms, median, open_device
from mnasnet_tpu_torch.utils.routing import BatchRouted, route_for_batch

SERVING_COUNTERS = ("dw_conv_bn_act", "mbconv_block")
IMPLS = ("kernel", "torch")


def routed(fn, route: str, device) -> BatchRouted:
    """``fn`` on ``route`` at every batch size."""
    return BatchRouted(fn, route_for=lambda b: route, device=device)


def launches_of(fn, x, on_card: bool) -> dict | None:
    """The serving kernels' launches of one call ``fn(x)`` (None off the card:
    a CPU tensor takes the plain versions, which count nothing)."""
    before = counts()
    fn(x)
    if not on_card:
        return None
    torch.cuda.synchronize()
    after = counts()
    return {k: after[k] - before[k] for k in SERVING_COUNTERS}


def fastest(row: dict, prefix: str, routes) -> str | None:
    timed = [r for r in routes if row.get(f"{prefix}_{r}_ms") is not None]
    return min(timed, key=lambda r: row[f"{prefix}_{r}_ms"]) if timed else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mnasnet1_0")
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--batches", default="1,2,4,8,16,32,64,128")
    ap.add_argument("--routes", default="eager,graph")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--target-ms", type=float, default=100.0, help="length of one window")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", type=Path, default=Path("build/bench_latency.json"))
    args = ap.parse_args(argv)
    device = open_device(args.device, "bench_latency")
    on_card = device.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    impls, routes = IMPLS, args.routes.split(",")
    img = args.image_size

    predict = {impl: make_predict_fn(create_model(args.arch, device=device,
                                                  dtype=torch.bfloat16, dw_impl=impl, seed=0))
               for impl in impls}
    served = {(impl, r): routed(predict[impl], r, device) for impl in impls for r in routes}
    g = torch.Generator(device=device).manual_seed(1)
    table = []
    for bs in [int(b) for b in args.batches.split(",")]:
        x = torch.randn(bs, img, img, 3, device=device, generator=g)
        row: dict = {"batch": bs, "launches_per_forward": {
            impl: launches_of(predict[impl], x, on_card) for impl in impls}}
        for fn in served.values():
            fn(x)  # warm-up, and a graph's capture
        times = interleaved_ms({key: (lambda f=fn: f(x)) for key, fn in served.items()},
                               args.repeats, args.target_ms) if on_card else {}
        for (impl, r) in served:
            ms = median(times.get((impl, r)))
            row[f"{impl}_{r}_ms"] = ms
            row[f"{impl}_{r}_ips"] = None if ms is None else bs / ms * 1e3
        for impl in impls:
            best = fastest(row, impl, routes)
            row[f"{impl}_route"] = best
            row[f"{impl}_ms"] = row[f"{impl}_{best}_ms"] if best else None
            row[f"{impl}_ips"] = row[f"{impl}_{best}_ips"] if best else None
        row["kernel_speedup"] = (row["torch_ms"] / row["kernel_ms"]
                                 if row.get("kernel_ms") and row.get("torch_ms") else None)
        row["table_route"] = route_for_batch(bs)
        row["agrees_with_table"] = (None if row.get("kernel_route") is None
                                    else row["kernel_route"] == row["table_route"])
        table.append(row)
        print(json.dumps(row), flush=True)

    wins = [r["batch"] for r in table if (r.get("kernel_speedup") or 0) > 1.02]
    out = {"tool": "bench_latency", **card_info(device), "arch": args.arch, "image_size": img,
           "dtype": "bfloat16", "impls": impls, "routes": routes,
           "method": f"make_predict_fn of the live model per impl and route; CUDA events, "
                     f"every (impl, route) in turns, median of {args.repeats} windows of "
                     f"~{args.target_ms} ms",
           "table": table,
           "kernel_wins_at_batches": wins if on_card else None,
           "route_table_disagrees_at": [r["batch"] for r in table
                                        if r["agrees_with_table"] is False]}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1) + "\n")
    print(json.dumps({"kernel_wins_at_batches": out["kernel_wins_at_batches"],
                      "route_table_disagrees_at": out["route_table_disagrees_at"]}))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
