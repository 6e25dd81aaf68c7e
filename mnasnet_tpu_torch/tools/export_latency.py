"""Serving-artifact latency: the exported artifact against the live forward.

Counterpart of ``tools/export_latency.py``. One symbolic-batch artifact of
the seeded bf16 model (``tools/export_serving.py:build_forward`` with the
kernel ops, ``export_artifact``) is loaded with ``serving.load_serving`` on
each route; the live forward is the same ``build_forward`` module, routed
the same way (``utils/routing.py:BatchRouted``). At each of ``--batches``
the eager route's logits of the two are compared, and each route (the
compile route at ``COMPILE_BATCHES`` only: a cold Inductor compile takes
30-50 s) times live and artifact in turns with CUDA events after warm-up,
as the median of ``--repeats`` windows. Each row gives both ms per batch,
images/s, ``artifact_vs_live_pct`` and the first call's seconds (a graph's
capture, a compile); each batch size its fastest route for the artifact and
whether ``SERVE_ROUTE_BATCH_RANGES`` gives that route; the top level the
artifact's bytes and its export and load seconds.

    python -m mnasnet_tpu_torch.tools.export_latency [--arch mnasnet1_0] \\
        [--batches 1,8,32,128] [--routes eager,graph,compile] [--out F.json]
    python -m mnasnet_tpu_torch.tools.export_latency --device cpu --arch mnasnet0_35 \\
        --image-size 32 --batches 1,3 --routes eager --out e.json

Runs on the card (``--device``, default cuda) and exits non-zero when the
device it is asked for is not there; with ``--device cpu`` each call runs
once and the card's keys (times, launches) are null.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from mnasnet_tpu_torch.serving import load_serving
from mnasnet_tpu_torch.tools.bench_latency import launches_of, routed
from mnasnet_tpu_torch.tools.export_serving import build_forward, export_artifact
from mnasnet_tpu_torch.utils.card import card_info, interleaved_ms, median, open_device
from mnasnet_tpu_torch.utils.routing import route_for_batch

COMPILE_BATCHES = (1, 128)

def first_call_s(fn, x, on_card: bool) -> float | None:
    """Seconds of one call, to its end on the card (a graph's warm-up and
    capture, or a compile, on a new shape); None off the card."""
    t0 = time.perf_counter()
    fn(x)
    if not on_card:
        return None
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mnasnet1_0")
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--batches", default="1,8,32,128")
    ap.add_argument("--routes", default="eager,graph,compile")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--target-ms", type=float, default=100.0, help="length of one window")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", type=Path, default=Path("build/export_latency.json"))
    args = ap.parse_args(argv)
    device = open_device(args.device, "export_latency")
    on_card = device.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    routes = args.routes.split(",")
    img = args.image_size

    fn, x0 = build_forward(args.arch, 1000, "bfloat16", None, img, 8, device=device)
    t0 = time.perf_counter()
    blob = export_artifact(fn, x0, symbolic_batch=True)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    artifact = {"eager": load_serving(blob, route="eager", device=device)}
    load_s = time.perf_counter() - t0
    artifact.update({r: load_serving(blob, route=r, device=device) for r in routes
                     if r != "eager"})
    live_fn = torch.no_grad()(lambda images: fn(images))
    live = {r: routed(live_fn, r, device) for r in {"eager", *routes}}

    g = torch.Generator(device=device).manual_seed(0)
    rows, by_batch = [], []
    for bs in [int(b) for b in args.batches.split(",")]:
        x = torch.randn(bs, img, img, 3, device=device, generator=g)
        got, want = artifact["eager"](x), live["eager"](x)
        summary = {"batch": bs, "eager_max_abs_diff": float((got - want).abs().max()),
                   "eager_bitwise": bool(torch.equal(got, want)),
                   "artifact_launches_per_call": launches_of(artifact["eager"], x, on_card)}
        for r in routes:
            if r == "compile" and bs not in COMPILE_BATCHES:
                continue
            row = {"batch": bs, "route": r,
                   "live_first_call_s": first_call_s(live[r], x, on_card),
                   "artifact_first_call_s": first_call_s(artifact[r], x, on_card)}
            times = interleaved_ms({"live": lambda f=live[r]: f(x),
                                    "artifact": lambda f=artifact[r]: f(x)},
                                   args.repeats, args.target_ms) if on_card else {}
            for side in ("live", "artifact"):
                ms = median(times.get(side))
                row[f"{side}_ms"] = ms
                row[f"{side}_ips"] = None if ms is None else bs / ms * 1e3
            row["artifact_vs_live_pct"] = (100 * (row["artifact_ms"] / row["live_ms"] - 1)
                                           if on_card else None)
            rows.append(row)
            print(json.dumps(row), flush=True)
        timed = [r for r in rows if r["batch"] == bs and r["artifact_ms"] is not None]
        best = min(timed, key=lambda r: r["artifact_ms"])["route"] if timed else None
        summary.update({"fastest_route": best, "table_route": route_for_batch(bs),
                        "agrees_with_table": None if best is None
                        else best == route_for_batch(bs)})
        by_batch.append(summary)
        print(json.dumps(summary), flush=True)

    out = {"tool": "export_latency", **card_info(device), "arch": args.arch,
           "image_size": img, "dtype": "bfloat16",
           "artifact": {"bytes": len(blob), "symbolic_batch": True, "export_seconds": export_s,
                        "load_seconds": load_s,
                        "note": "load = torch.export.load and the move to the device; a "
                                "route's first call on a shape (capture, compile) is in "
                                "the rows"},
           "method": f"live build_forward against its load_serving artifact per route; CUDA "
                     f"events, live and artifact in turns, median of {args.repeats} windows "
                     f"of ~{args.target_ms} ms",
           "rows": rows, "by_batch": by_batch,
           "route_table_disagrees_at": [s["batch"] for s in by_batch
                                        if s["agrees_with_table"] is False]}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
