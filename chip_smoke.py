#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``mnasnet_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # full run: checks and timings
    python3 chip_smoke.py --no-timing  # checks only, for a first run of new kernels
    python3 chip_smoke.py --profile DIR  # also per-kernel device time tables in DIR

Phases, in order; any failure raises and exits non-zero:
  1. device: requires CUDA and prints the card's name and power limit;
  2. build: compiles ``mnasnet_tpu_torch/csrc/*.cu`` with nvcc (all at once);
  3. dw: the fused depthwise kernel against its plain version at the 12
     depthwise shapes of mnasnet1_0@224, batch 128, bf16 and fp32;
  4. mbconv: the fused MBConv kernel against its plain version at the 16
     block shapes of mnasnet1_0@224, batch 128, bf16 and fp32;
  5. serving: ``create_model("mnasnet1_0", dtype=bf16)`` with seeded weights
     and calibrated BN statistics, driven through ``make_predict_fn`` on
     batches of 128x224x224x3; counts the kernel launches of those forwards,
     holds the logits against the "torch" route and an fp32 reference,
     answers one single-image request, and times images/s at batch 128 and
     the latency of a batch of one.
It then prints the ``kernels`` JSON line, the card line, and as its last line
``{"ok": true, "device": {...}}``.

Tolerances (normalised by the largest magnitude of the reference):
  * kernel vs plain version, fp32: 1e-5 (dw) and 1e-4 (MBConv) — the same
    fp32 arithmetic summed in another order;
  * kernel vs plain version, bf16: 2^-7 (dw) and 2^-6 (MBConv) — one and two
    bf16 ulps at the largest output, for roundings that flip where the fp32
    sums differ in their last bit;
  * whole model, fp32, kernel route vs torch route: 1e-4;
  * whole model, bf16: max |kernel route - torch route| <= 0.25 of the
    largest logit, and the kernel route's relative RMS error against the fp32
    reference at most 1.25x the torch route's plus 0.01. Random weights make
    logits that lie close together, so bf16 rounding moves the top-1 of many
    images on either route; the top-1 agreement is printed, and held to 0.5.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

from mnasnet_tpu_torch import create_model
from mnasnet_tpu_torch.data.transforms import eval_transform
from mnasnet_tpu_torch.models.layers import BatchNorm, nchw
from mnasnet_tpu_torch.ops.cuda import _build
from mnasnet_tpu_torch.ops.cuda.dw_conv import dw_conv_bn_act, dw_conv_reference, out_size
from mnasnet_tpu_torch.ops.cuda.mbconv import mbconv_fused, mbconv_reference, plan
from mnasnet_tpu_torch.tools.tune_plans import (
    BATCH,
    IMAGE,
    block_shapes,
    dw_shapes,
    random_block,
    time_ms,
)
from mnasnet_tpu_torch.train.steps import make_predict_fn

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_FLOPS = {"bfloat16": 989e12,  # dense bf16 tensor-core rate
              "float32": 67e12}    # fp32 outside the tensor cores (TF32 off)
TOL_DW = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
TOL_MB = {"float32": 1e-4, "bfloat16": 2.0 ** -6}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def bound(nbytes: int, flops: int, dtype_name: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rel_err(out, ref) -> float:
    return float((out.float() - ref.float()).abs().max() / ref.float().abs().max().clamp(min=1e-30))


def dw_phase(timing: bool) -> list[dict]:
    g = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for h, c, k, s in dw_shapes():
        for dt in (torch.bfloat16, torch.float32):
            name = str(dt).split(".")[1]
            x = torch.randn(BATCH, h, h, c, device="cuda", generator=g).to(dt)
            w = torch.randn(k, k, 1, c, device="cuda", generator=g) * 0.3
            scale = torch.rand(c, device="cuda", generator=g) + 0.5
            bias = torch.randn(c, device="cuda", generator=g) * 0.1
            y = dw_conv_bn_act(x, w, scale, bias, stride=s, relu=True)
            ref = dw_conv_reference(x, w, scale, bias, stride=s, relu=True)
            torch.cuda.synchronize()
            if y.shape != ref.shape or y.dtype != dt or not torch.isfinite(y).all():
                raise RuntimeError(f"dw {h}x{h}x{c} k{k} s{s} {name}: bad output")
            err = rel_err(y, ref)
            row = {"shape": f"{h}x{h}x{c} k{k} s{s}", "dtype": name,
                   "max_abs_err": float((y.float() - ref.float()).abs().max()),
                   "rel_err": err, "tol": TOL_DW[name]}
            if err > TOL_DW[name]:
                raise RuntimeError(f"dw {row['shape']} {name}: error {err:.3g} > {TOL_DW[name]}")
            ho = out_size(h, k, s)
            nbytes = (x.numel() + BATCH * ho * ho * c) * x.element_size() + (k * k + 2) * c * 4
            row["bound_ms"], row["bound_by"] = bound(nbytes, 2 * k * k * BATCH * ho * ho * c, name)
            if timing:
                row["ms"] = time_ms(lambda: dw_conv_bn_act(x, w, scale, bias, stride=s))
                row["plain_ms"] = time_ms(lambda: dw_conv_reference(x, w, scale, bias, stride=s))
                # One cuDNN call for the same conv and affine (no ReLU): the
                # scale folded into the weights, the bias as the conv bias.
                xc = x.permute(0, 3, 1, 2)
                wf = (w.reshape(k, k, c) * scale).permute(2, 0, 1).unsqueeze(1).to(dt)
                bf = bias.to(dt)
                row["library_ms"] = time_ms(
                    lambda: F.conv2d(xc, wf, bf, stride=s, padding=k // 2, groups=c))
            log(f"[dw] {row}")
            rows.append(row)
            del x, y, ref
    return rows


def mbconv_phase(timing: bool) -> list[dict]:
    g = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for name_b, h, cin, cmid, cout, k, s in block_shapes():
        block, (x32, *weights), kw = random_block(h, cin, cmid, cout, k, s, g)
        ho = out_size(h, k, s)
        for dt in (torch.bfloat16, torch.float32):
            name = str(dt).split(".")[1]
            x = x32.to(dt)
            args = (x, *weights)
            with torch.no_grad():
                y = mbconv_fused(*args, **kw)
                ref = mbconv_reference(*args, **kw)
            torch.cuda.synchronize()
            if y.shape != (BATCH, ho, ho, cout) or not torch.isfinite(y).all():
                raise RuntimeError(f"mbconv {name_b} {name}: bad output")
            err = rel_err(y, ref)
            p = plan(h, h, cin, cmid, cout, k, s, x.element_size())
            row = {"block": name_b, "shape": f"{h}x{h} {cin}->{cmid}->{cout} k{k} s{s}",
                   "dtype": name, "max_abs_err": float((y.float() - ref.float()).abs().max()),
                   "rel_err": err, "tol": TOL_MB[name],
                   "plan": {"th": p.th, "tw": p.tw, "mc": p.mc, "threads": p.threads,
                            "smem": p.smem, "expand_recompute": p.expand_px / (h * h)}}
            if err > TOL_MB[name]:
                raise RuntimeError(f"mbconv {name_b} {name}: error {err:.3g} > {TOL_MB[name]}")
            nbytes = ((x.numel() + BATCH * ho * ho * cout) * x.element_size()
                      + (cin * cmid + k * k * cmid + cmid * cout) * x.element_size()
                      + (4 * cmid + 2 * cout) * 4)
            flops = 2 * BATCH * (h * h * cin * cmid + ho * ho * (k * k * cmid + cmid * cout))
            row["bound_ms"], row["bound_by"] = bound(nbytes, flops, name)
            if timing and dt == torch.bfloat16:
                with torch.no_grad():
                    row["ms"] = time_ms(lambda: mbconv_fused(*args, **kw))
                    row["plain_ms"] = time_ms(lambda: mbconv_reference(*args, **kw))
                    # The port's "torch" route for the whole block, as the model runs it.
                    xc = nchw(x)
                    row["torch_route_ms"] = time_ms(lambda: block(xc))
            log(f"[mbconv] {row}")
            rows.append(row)
            del x, y, ref
    return rows


def calibrate_bn(model, images) -> None:
    """Set every BN's running statistics to the batch statistics of its input
    on ``images``, in one forward (each BN then normalises what it sees):
    random weights with the init's unit statistics make activations vanish."""
    def hook(bn, args):
        v = args[0].float()
        bn.running_mean.copy_(v.mean(dim=(0, 2, 3)))
        bn.running_var.copy_(v.var(dim=(0, 2, 3), unbiased=False))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, BatchNorm)]
    try:
        with torch.no_grad():
            model(images)
    finally:
        for hd in handles:
            hd.remove()


def serving_phase(timing: bool, card: str, profile_dir: Path | None) -> dict:
    g = torch.Generator(device="cuda").manual_seed(3)
    ref32 = create_model("mnasnet1_0", dtype=torch.float32, dw_impl="torch", seed=0)
    calib = torch.randn(32, 3, IMAGE, IMAGE, device="cuda", generator=g)
    calibrate_bn(ref32, calib)
    state = ref32.state_dict()

    def model(dtype, impl):
        m = create_model("mnasnet1_0", dtype=dtype, dw_impl=impl, seed=0)
        m.load_state_dict(state)
        return m

    served = model(torch.bfloat16, "auto")
    predict = make_predict_fn(served)
    batches = [torch.randn(BATCH, IMAGE, IMAGE, 3, device="cuda", generator=g) for _ in range(3)]

    # The main path: counts set to 0 just before, read just after.
    dw_conv_bn_act.launches = 0
    mbconv_fused.launches = 0
    logits = [predict(b) for b in batches]
    torch.cuda.synchronize()
    launches = {"dw_conv_bn_act": dw_conv_bn_act.launches, "mbconv_block": mbconv_fused.launches}
    log(f"[serving] launches over {len(batches)} forwards: {launches}")
    if launches != {"dw_conv_bn_act": len(batches), "mbconv_block": 16 * len(batches)}:
        raise RuntimeError(f"expected 1 dw and 16 MBConv launches per forward, got {launches}")

    out = {"launches": launches}
    torch_bf16 = make_predict_fn(model(torch.bfloat16, "torch"))
    kernel_32 = make_predict_fn(model(torch.float32, "kernel"))
    ref_fn = make_predict_fn(ref32)
    k_all = torch.cat(logits)
    t_all = torch.cat([torch_bf16(b) for b in batches])
    f_all = torch.cat([ref_fn(b) for b in batches])
    k32_all = torch.cat([kernel_32(b) for b in batches])
    for name, v in (("kernel_bf16", k_all), ("torch_bf16", t_all), ("kernel_fp32", k32_all)):
        if v.shape != (len(batches) * BATCH, 1000) or v.dtype != torch.float32 \
                or not torch.isfinite(v).all():
            raise RuntimeError(f"{name} logits: bad output {tuple(v.shape)} {v.dtype}")

    def rrms(a, b):
        return float((a - b).norm() / b.norm())

    out["fp32_kernel_vs_torch_rel_err"] = rel_err(k32_all, f_all)
    out["fp32_top1_agreement"] = float((k32_all.argmax(-1) == f_all.argmax(-1)).float().mean())
    out["bf16_max_abs_diff"] = float((k_all - t_all).abs().max())
    out["bf16_tol"] = 0.25 * float(t_all.abs().max())
    out["bf16_top1_agreement"] = float((k_all.argmax(-1) == t_all.argmax(-1)).float().mean())
    out["bf16_kernel_rel_rms_vs_fp32"] = rrms(k_all, f_all)
    out["bf16_torch_rel_rms_vs_fp32"] = rrms(t_all, f_all)
    log(f"[serving] agreement: {json.dumps(out)}")
    if out["fp32_kernel_vs_torch_rel_err"] > 1e-4:
        raise RuntimeError("fp32 kernel route disagrees with the torch route")
    if out["bf16_max_abs_diff"] > out["bf16_tol"]:
        raise RuntimeError("bf16 kernel route disagrees with the torch route")
    if out["bf16_kernel_rel_rms_vs_fp32"] > 1.25 * out["bf16_torch_rel_rms_vs_fp32"] + 0.01:
        raise RuntimeError("bf16 kernel route is further from fp32 than the torch route")
    if out["bf16_top1_agreement"] < 0.5:
        raise RuntimeError("bf16 kernel route and torch route agree on top-1 for under half")

    # One single-image request: a seeded PIL image through the eval transform.
    rng = np.random.default_rng(0)
    img = Image.fromarray(rng.integers(0, 256, (300, 400, 3), dtype=np.uint8))
    probs = torch.softmax(predict(eval_transform(img, IMAGE)[None]), dim=-1)[0]
    top = torch.topk(probs, 5)
    out["single_image_top5"] = [[int(i), round(float(p), 6)]
                                for p, i in zip(top.values, top.indices)]
    log(f"[serving] single image top-5: {out['single_image_top5']}")

    if timing:
        x, x1 = batches[0], batches[0][:1]
        for name, fn in (("kernel", predict), ("torch", torch_bf16)):
            ms = time_ms(lambda: fn(x), target_ms=1000.0)
            out[f"{name}_route_ms_per_batch"] = ms
            out[f"{name}_route_images_per_s"] = BATCH / ms * 1e3
            out[f"{name}_route_ms_single_image"] = time_ms(lambda: fn(x1), target_ms=200.0)
            if profile_dir is not None:
                out[f"{name}_route_profile"] = profile_forward(
                    fn, x, profile_dir / f"profile_{name}_route.txt")
        log(f"[serving] bs{BATCH} bf16 images/s: kernel route "
            f"{out['kernel_route_images_per_s']:.1f}, torch route "
            f"{out['torch_route_images_per_s']:.1f}; bs1 ms: kernel route "
            f"{out['kernel_route_ms_single_image']:.3f}, torch route "
            f"{out['torch_route_ms_single_image']:.3f} on {card}")
    return out


def profile_forward(predict, x, path: Path) -> dict:
    """Device time by kernel over 3 forwards (torch.profiler), written as a
    table to ``path``; returns the kernel time per forward and its share of
    the forward's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    predict(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            predict(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / 3
    events = prof.key_averages()
    key = ("self_device_time_total" if hasattr(events[0], "self_device_time_total")
           else "self_cuda_time_total")
    path.write_text(events.table(sort_by=key, row_limit=40))
    # Kernel rows only: the rows of aten ops repeat their kernels' time.
    device_ms = sum(getattr(e, key) for e in events
                    if getattr(e, "device_type", None) == DeviceType.CUDA) / 1e3 / 3
    return {"device_ms_per_forward": device_ms, "wall_ms_per_forward": wall_ms,
            "device_busy_share": device_ms / wall_ms}


def kernels_line(dw_rows, mb_rows, serving) -> dict:
    sep = next(r for r in dw_rows if r["shape"] == "112x112x32 k3 s1" and r["dtype"] == "bfloat16")
    mb = [r for r in mb_rows if r["dtype"] == "bfloat16"]

    def total(key):
        return sum(r[key] for r in mb) if all(key in r for r in mb) else None

    by_bytes = sum(r["bound_ms"] for r in mb if r["bound_by"] == "bytes")
    return {"kernels": [
        {"name": "dw_conv_bn_act", "route": "cuda", "source": "mnasnet_tpu_torch/csrc/dw_conv.cu",
         "replaces": "mnasnet_tpu/ops/pallas/dw_conv.py:56",
         "also_replaces": "mnasnet_tpu/ops/pallas/dw_conv.py:96",
         "launches": serving["launches"]["dw_conv_bn_act"],
         "max_abs_err": sep["max_abs_err"], "ms": sep.get("ms"),
         "plain_ms": sep.get("plain_ms"), "bound_ms": sep["bound_ms"],
         "bound_by": sep["bound_by"], "library_ms": sep.get("library_ms"),
         "shapes": dw_rows},
        {"name": "mbconv_block", "route": "cuda", "source": "mnasnet_tpu_torch/csrc/mbconv.cu",
         "replaces": "mnasnet_tpu/ops/pallas/mbconv.py:58",
         "launches": serving["launches"]["mbconv_block"],
         "max_abs_err": max(r["max_abs_err"] for r in mb), "ms": total("ms"),
         "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
         "bound_by": "bytes" if by_bytes * 2 >= total("bound_ms") else "operations",
         "library_ms": None, "torch_route_ms": total("torch_route_ms"),
         "shapes": mb_rows},
    ]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--no-timing", action="store_true", help="run the checks only")
    ap.add_argument("--profile", type=Path, default=None, metavar="DIR",
                    help="also write torch.profiler tables of one forward per route to DIR")
    args = ap.parse_args()
    timing = not args.no_timing
    if args.profile is not None:
        args.profile.mkdir(parents=True, exist_ok=True)

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; nvidia-smi: {card}")

    t0 = time.perf_counter()
    _build.build()
    log(f"[build] kernels ready in {time.perf_counter() - t0:.1f} s "
        f"(per source: {_build.build_seconds})")

    t0 = time.perf_counter()
    dw_rows = dw_phase(timing)
    log(f"[dw] phase done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mb_rows = mbconv_phase(timing)
    log(f"[mbconv] phase done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    serving = serving_phase(timing, card, args.profile)
    log(f"[serving] phase done in {time.perf_counter() - t0:.1f} s")

    log(json.dumps(kernels_line(dw_rows, mb_rows, serving)))
    log(json.dumps({"serving": serving}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
