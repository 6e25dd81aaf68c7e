"""Train-step variants of the port on the card: the counterpart of
``tools/bench_train_variants.py``, with the reference's variant names where
the knob exists in the port.

    python -m mnasnet_tpu_torch.tools.train_variants [--variants best,best-remat]
        [--batch-sizes 128,512] [--routes graph,eager] [--out F.json]
    python -m mnasnet_tpu_torch.tools.train_variants --eval [--batch-sizes 1,128]

Train mode: for each variant and batch size, mnasnet1_0 at 224 px, bf16, on
each route (default ``TRAIN_ROUTE`` and eager), ms per step from CUDA events
over repeated steps on one seeded batch, images/s, the peak allocated and
reserved memory of its first two calls beyond what was held before its
model was made (a graph's warm-up step sets it; replays allocate nothing),
and the kernels' launches per step the counters see
(``TrainRouted.counted``). ``best`` is the production step (external BN EMA,
``fused="small"`` RMSProp, s2d stem); ``base`` the reference's defaults.

Eval mode (``--eval``): the serving forward (``make_predict_fn``) under each
``pw_lowering`` on the graph route, ms per batch at each batch size, on the
kernel route (``dw_impl="auto"``: the fused blocks run no separate 1x1
conv) and on the torch route (every block's 1x1 convs as lowered).

Runs on the card (``--device``, default cuda) and exits non-zero when the
device it is asked for is not there.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

import torch

from mnasnet_tpu_torch import create_model
from mnasnet_tpu_torch.ops.cuda.bn_bwd import bn_bwd_dx, bn_bwd_reduce, bn_fwd_stats, bn_relu_apply
from mnasnet_tpu_torch.ops.cuda.dw_conv import dw_conv_bn_act
from mnasnet_tpu_torch.ops.cuda.mbconv import mbconv_fused
from mnasnet_tpu_torch.tools.tune_plans import time_ms
from mnasnet_tpu_torch.train.optim import create_optimizer
from mnasnet_tpu_torch.train.state import TrainState
from mnasnet_tpu_torch.train.steps import make_predict_fn, make_train_step
from mnasnet_tpu_torch.utils.routing import TRAIN_ROUTE, BatchRouted

ARCH, IMAGE, LR = "mnasnet1_0", 224, 0.01
COUNTERS = {"dw_conv_bn_act": dw_conv_bn_act, "mbconv_block": mbconv_fused,
            "bn_bwd_reduce": bn_bwd_reduce, "bn_bwd_dx": bn_bwd_dx,
            "bn_fwd_stats": bn_fwd_stats, "bn_relu_apply": bn_relu_apply}

# Model and optimizer knobs of each variant, over the reference's defaults
# (module BN EMA, unfused optimizer, no s2d stem); "fused" is the optimizer's.
_BEST = dict(bn_ema="external", fused="small", stem_s2d=True)
VARIANTS = {
    "base": dict(),
    "best": dict(_BEST),
    "best-remat": dict(_BEST, remat=True),
    "pwdot": dict(pw_lowering="dot"),
    "best-pwconv": dict(_BEST, pw_lowering="conv"),
    "best-cpad64": dict(_BEST, channel_pad=64),
    "best-cpad128": dict(_BEST, channel_pad=128),
    "taps": dict(dw_impl="taps"),
    "best-taps": dict(_BEST, dw_impl="taps"),
    "best-taps2": dict(_BEST, dw_impl="taps2"),
    "hyb2": dict(dw_impl="hybrid"),
    "best-hyb2": dict(_BEST, dw_impl="hybrid"),
}


def counts() -> dict:
    return {name: fn.launches for name, fn in COUNTERS.items()}


def memory_base(device) -> tuple[int, int]:
    """Allocated and reserved bytes now, the allocator's cache released and
    the peak reset: the base a variant's memory is counted from."""
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    return torch.cuda.memory_allocated(device), torch.cuda.memory_reserved(device)


def train_batch(batch: int, device, image: int = IMAGE, seed: int = 5):
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(batch, image, image, 3, device=device, generator=g),
            torch.randint(0, 1000, (batch,), device=device, generator=g))


def time_train(knobs: dict, route: str, images, labels, target_ms: float = 2000.0,
               seed: int = 0, grad_accum: int = 1, arch: str = ARCH,
               repeats: int = 1) -> dict:
    """One variant (``arch``, bf16, ``knobs`` for the model and "fused"
    for RMSProp) on one train route: ms per step, images/s, peak memory and
    launches per counted step (the first two calls: a graph's warm-up and
    capture, or two eager or compiled steps). ``grad_accum`` microbatches a
    step; ``repeats`` windows of about ``target_ms`` each, whose median is
    ``ms_per_step`` (each in ``ms_repeats``)."""
    device = images.device
    base = memory_base(device)
    knobs = dict(knobs)
    fused = knobs.pop("fused", False)
    model = create_model(arch, device=device, dtype=torch.bfloat16, seed=seed, **knobs)
    tx = create_optimizer("rmsprop", LR, fused=fused)
    state = TrainState.create(model, tx, seed=seed)
    step = make_train_step(model, tx, label_smoothing=0.1, route=route, grad_accum=grad_accum)
    before = counts()
    for _ in range(2):
        state, _ = step(state, images, labels)
    torch.cuda.synchronize(device)
    counted = step.counted()
    row = {"route": route, "batch": images.shape[0],
           "launches_per_step": {k: (v - before[k]) / counted for k, v in counts().items()},
           "peak_allocated_gb": (torch.cuda.max_memory_allocated(device) - base[0]) / 1e9,
           "peak_reserved_gb": (torch.cuda.max_memory_reserved(device) - base[1]) / 1e9}

    def one():
        step(state, images, labels)

    row["ms_repeats"] = [time_ms(one, target_ms=target_ms) for _ in range(repeats)]
    row["ms_per_step"] = statistics.median(row["ms_repeats"])
    row["images_per_s"] = images.shape[0] / row["ms_per_step"] * 1e3
    del model, tx, state, step
    return row


def time_serving(lowering: str, batch: int, device, seed: int = 0, arch: str = ARCH,
                 target_ms: float = 1000.0, dw_impl: str = "auto") -> dict:
    """The bf16 serving forward with ``pw_lowering=lowering`` on the graph
    route: ms per batch and the launches of its warm-up and capture. On the
    kernel route every block with a plan runs the fused MBConv kernel, whose
    1x1 convs are its own; ``dw_impl="torch"`` runs every block's 1x1 convs
    as lowered."""
    model = create_model(arch, device=device, dtype=torch.bfloat16, seed=seed,
                         pw_lowering=lowering, dw_impl=dw_impl)
    fn = BatchRouted(make_predict_fn(model), route_for=lambda b: "graph")
    x = train_batch(batch, device)[0]
    before = counts()
    fn(x)  # warm-up and capture
    torch.cuda.synchronize(device)
    launches = {k: v - before[k] for k, v in counts().items()}
    ms = time_ms(lambda: fn(x), target_ms=target_ms)
    return {"pw_lowering": lowering, "dw_impl": dw_impl, "batch": batch, "route": "graph",
            "ms_per_batch": ms,
            "images_per_s": batch / ms * 1e3, "launches_per_capture": launches}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default="base,best,best-remat",
                    help=f"comma-separated, of {sorted(VARIANTS)}")
    ap.add_argument("--batch-sizes", default=None,
                    help="comma-separated (default 128 in train mode, 1,128 with --eval)")
    ap.add_argument("--routes", default=f"{TRAIN_ROUTE},eager",
                    help="train routes, comma-separated")
    ap.add_argument("--eval", action="store_true",
                    help="time the serving forward per pw_lowering instead")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", type=Path, default=None, help="also write the rows as JSON")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type != "cuda" or not torch.cuda.is_available():
        print(f"train_variants times the card; no CUDA device for {args.device!r}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sizes = [int(b) for b in (args.batch_sizes or ("1,128" if args.eval else "128")).split(",")]
    rows = []
    if args.eval:
        for dw_impl in ("auto", "torch"):
            for bs in sizes:
                for lowering in ("dot", "conv", "conv", "dot"):  # alternating
                    rows.append(time_serving(lowering, bs, device, dw_impl=dw_impl))
                    print(json.dumps(rows[-1]), flush=True)
    else:
        for bs in sizes:
            images, labels = train_batch(bs, device)
            for name in args.variants.split(","):
                for route in args.routes.split(","):
                    row = {"variant": name, **time_train(VARIANTS[name], route, images,
                                                         labels)}
                    rows.append(row)
                    print(json.dumps(row), flush=True)
    print(torch.cuda.get_device_name(device))
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": torch.cuda.get_device_name(device),
                                        "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
