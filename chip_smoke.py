#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``mnasnet_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # full run: checks and timings
    python3 chip_smoke.py --no-timing  # checks only, for a first run of new kernels
    python3 chip_smoke.py --profile DIR  # also per-kernel device time tables in DIR
    python3 chip_smoke.py --only train   # the train phases only (a new kernel's first run)
    python3 chip_smoke.py --only kernels # the dw and mbconv phases only

Phases, in order; any failure raises and exits non-zero:
  1. device: requires CUDA and prints the card's name and power limit;
  2. build: compiles ``mnasnet_tpu_torch/csrc/*.cu`` with nvcc (all at once);
  3. dw: the fused depthwise kernel against its plain version at the 12
     depthwise shapes of mnasnet1_0@224, batch 128, bf16 and fp32; timed,
     also in the form one training step runs it (17 launches, unit affine,
     no ReLU), beside cuDNN's grouped convolution;
  4. mbconv: the fused MBConv kernel against its plain version at the 16
     block shapes of mnasnet1_0@224, batch 128, bf16 and fp32;
  5. serving: ``create_model("mnasnet1_0", dtype=bf16)`` with seeded weights
     and calibrated BN statistics, driven through ``make_predict_fn`` on
     batches of 128x224x224x3; counts the kernel launches of those forwards,
     holds the logits against the "torch" route and an fp32 reference,
     answers one single-image request, and times images/s at batch 128 and
     the latency of a batch of one;
  6. bn: the two BN+ReLU backward kernels against their plain versions at the
     35 BN+ReLU regions of the mnasnet1_0@224 training forward, batch 128,
     bf16 and fp32; the bf16 and fp32 ReLU masks exactly (with dy = 1, dβ
     must equal the count of positive forward outputs per channel); two
     launches bit-identical; and times, beside each kernel's bound, its plain
     version, one library call (``native_batch_norm_backward`` on the masked
     g) and the torch route's autograd of the region;
  7. dw training op: the depthwise autograd Function's gradients against the
     torch route's at one stride-1 and one stride-2 shape, bf16 and fp32;
  8. train: ``make_train_step`` on the production configuration
     (``create_model("mnasnet1_0", dtype=bf16, bn_ema="external",
     stem_s2d=True)``, ``create_optimizer("rmsprop", 0.01, fused="small")``,
     label smoothing 0.1) for 5 steps on one fixed batch of 128x224x224x3
     with seeded labels: the losses finite and falling from step 1 to step 5,
     and exactly 17 dw, 35 bn_bwd_reduce, 35 bn_bwd_dx and 0 MBConv launches
     per step; one fp32 step on the kernel route against the torch route
     from the same weights; images/s of both routes in bf16 and the step's
     peak memory.
It then prints the ``kernels`` JSON line, the card line, and as its last line
``{"ok": true, "device": {...}}``. A kernel's "ms" (and its plain version's
and library call's) is the time per call from CUDA events over back-to-back
eager calls through the counted wrapper, as the model makes them: where the
host takes longer to issue a call than the card to run it, the host's time
counts; "host_ms" beside it is the host's time per call alone. ``--profile``
gives the device time of each of the port's kernels per forward and step.

Tolerances (normalised by the largest magnitude of the reference):
  * kernel vs plain version, fp32: 1e-5 (dw) and 1e-4 (MBConv) — the same
    fp32 arithmetic summed in another order;
  * kernel vs plain version, bf16: 2^-7 (dw) and 2^-6 (MBConv) — one and two
    bf16 ulps at the largest output, for roundings that flip where the fp32
    sums differ in their last bit;
  * whole model, fp32, kernel route vs torch route: 1e-4;
  * BN backward kernels vs plain versions: dγ and dβ 1e-4 in both dtypes
    (fp32 sums of the same terms over up to 1.6 M rows, in another order),
    dx 1e-4 (fp32) and 2^-7 (bf16, one ulp where the fp32 values differ in
    their last bits); the mask counts exactly;
  * dw training op vs torch route: dx 1e-4 (fp32) and 2^-7 (bf16); dw 1e-4
    (fp32) and 2^-6 (bf16: the torch route rounds its weight gradient to
    bf16, the Function sums in fp32);
  * one fp32 training step, kernel route vs torch route: loss within 1e-5
    relative, BN running statistics within 1e-5 relative, and the parameter
    update p - p0 within 1e-2 relative RMS over all parameters (the
    elementwise count outside rtol 5e-3 / atol 1e-4 is printed: at random
    init a 1e-7 forward difference can flip a ReLU mask and move single
    gradient elements by more);
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
from mnasnet_tpu_torch.ops.cuda.bn_bwd import (
    _fwd_math,
    bn_bwd_dx,
    bn_bwd_dx_reference,
    bn_bwd_reduce,
    bn_bwd_reduce_reference,
    relu_mask_reference,
)
from mnasnet_tpu_torch.ops.cuda.dw_conv import (
    depthwise_conv_train,
    dw_conv_bn_act,
    dw_conv_reference,
    out_size,
)
from mnasnet_tpu_torch.ops.cuda.dw_conv import plan as dw_plan
from mnasnet_tpu_torch.ops.cuda.mbconv import mbconv_fused, mbconv_reference, plan
from mnasnet_tpu_torch.ops.depthwise import depthwise_conv2d
from mnasnet_tpu_torch.tools.tune_plans import (
    BATCH,
    IMAGE,
    block_shapes,
    bn_region_shapes,
    dw_shapes,
    random_block,
    time_ms,
    train_dw_shapes,
)
from mnasnet_tpu_torch.train.optim import create_optimizer
from mnasnet_tpu_torch.train.state import TrainState
from mnasnet_tpu_torch.train.steps import make_predict_fn, make_train_step

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_FLOPS = {"bfloat16": 989e12,  # dense bf16 tensor-core rate
              "float32": 67e12}    # fp32 outside the tensor cores (TF32 off)
TOL_DW = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
TOL_MB = {"float32": 1e-4, "bfloat16": 2.0 ** -6}
TOL_BN_SUMS = {"float32": 1e-4, "bfloat16": 1e-4}
TOL_BN_DX = {"float32": 1e-4, "bfloat16": 2.0 ** -7}
TOL_DW_TRAIN = {"float32": (1e-4, 1e-4), "bfloat16": (2.0 ** -7, 2.0 ** -6)}  # (dx, dw)
BN_EPS = 1e-5
# The production train configuration (bench.py's "optimized" build): the
# learning rate its RMSProp is timed at.
TRAIN_LR = 0.01
TRAIN_STEPS = 5
LAUNCHES_PER_STEP = {"dw_conv_bn_act": 17, "bn_bwd_reduce": 35, "bn_bwd_dx": 35,
                     "mbconv_block": 0}
COUNTERS = {"dw_conv_bn_act": dw_conv_bn_act, "mbconv_block": mbconv_fused,
            "bn_bwd_reduce": bn_bwd_reduce, "bn_bwd_dx": bn_bwd_dx}
# The port's kernels by a part of their CUDA function names, for profiles.
KERNEL_NAMES = {"dw_conv_bn_act": "dw_conv_kernel", "mbconv_block": "mbconv_",
                "bn_bwd_reduce": "bn_reduce_", "bn_bwd_dx": "bn_dx_kernel"}


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


def host_ms(fn, iters: int = 50) -> float:
    """Host time of one call of ``fn``: the wall time of issuing ``iters``
    calls without waiting for the card, fewer than its launch queue holds.
    Where it reaches the call's ``time_ms``, the host sets that time, not
    the kernel."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / iters * 1e3


def _dw_bytes(x, ho, c, k) -> int:
    """Bytes the dw kernel must move: x read and y written once, the fp32
    weights, scale and bias read once."""
    return (x.numel() + BATCH * ho * ho * c) * x.element_size() + (k * k + 2) * c * 4


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
            p = dw_plan(BATCH, h, h, c, k, s, x.element_size())
            row = {"shape": f"{h}x{h}x{c} k{k} s{s}", "dtype": name,
                   "max_abs_err": float((y.float() - ref.float()).abs().max()),
                   "rel_err": err, "tol": TOL_DW[name], "plan": p._asdict()}
            if err > TOL_DW[name]:
                raise RuntimeError(f"dw {row['shape']} {name}: error {err:.3g} > {TOL_DW[name]}")
            ho = out_size(h, k, s)
            row["bound_ms"], row["bound_by"] = bound(
                _dw_bytes(x, ho, c, k), 2 * k * k * BATCH * ho * ho * c, name)
            if timing:
                row["ms"] = time_ms(lambda: dw_conv_bn_act(x, w, scale, bias, stride=s))
                row["host_ms"] = host_ms(lambda: dw_conv_bn_act(x, w, scale, bias, stride=s))
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


def dw_train_timing() -> dict:
    """The dw kernel as one training step runs it: the 17 depthwise convs of
    the forward (``train_dw_shapes``), bf16, unit scale, zero bias, no ReLU,
    through ``dw_conv_bn_act``. Sums over the step of the kernel's time, its
    bound, its plain version and one cuDNN call of the same conv
    (``F.conv2d(groups=C)``, no bias)."""
    g = torch.Generator(device="cuda").manual_seed(7)
    shapes = train_dw_shapes()
    out = {"summed_over": len(shapes), "ms": 0.0, "host_ms": 0.0, "plain_ms": 0.0,
           "library_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0}
    for (h, c, k, s) in sorted(set(shapes)):
        times = shapes.count((h, c, k, s))
        x = torch.randn(BATCH, h, h, c, device="cuda", generator=g).to(torch.bfloat16)
        w = torch.randn(k, k, 1, c, device="cuda", generator=g) * 0.3
        ones = torch.ones(c, device="cuda")
        zeros = torch.zeros(c, device="cuda")
        y = dw_conv_bn_act(x, w, ones, zeros, stride=s, relu=False)
        ref = dw_conv_reference(x, w, ones, zeros, stride=s, relu=False)
        err = rel_err(y, ref)
        if err > TOL_DW["bfloat16"]:
            raise RuntimeError(f"dw training form {h}x{h}x{c} k{k} s{s}: error {err:.3g}")
        out["max_abs_err"] = max(out["max_abs_err"], float((y.float() - ref.float()).abs().max()))
        ho = out_size(h, k, s)
        out["bound_ms"] += times * bound(_dw_bytes(x, ho, c, k),
                                         2 * k * k * BATCH * ho * ho * c, "bfloat16")[0]
        xc = x.permute(0, 3, 1, 2)
        wc = w.reshape(k, k, c).permute(2, 0, 1).unsqueeze(1).to(torch.bfloat16)
        for key, fn in (("ms", lambda: dw_conv_bn_act(x, w, ones, zeros, stride=s, relu=False)),
                        ("plain_ms", lambda: dw_conv_reference(x, w, ones, zeros, stride=s,
                                                               relu=False)),
                        ("library_ms", lambda: F.conv2d(xc, wc, None, stride=s,
                                                        padding=k // 2, groups=c))):
            out[key] += times * time_ms(fn, 30.0)
        out["host_ms"] += times * host_ms(
            lambda: dw_conv_bn_act(x, w, ones, zeros, stride=s, relu=False))
        del x, y, ref, xc
    log(f"[dw] training step, {out['summed_over']} launches: {out}")
    return out


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
                    row["host_ms"] = host_ms(lambda: mbconv_fused(*args, **kw))
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


def profile_forward(fn, x, path: Path) -> dict:
    """Device time by kernel over 3 calls of ``fn(x)`` (torch.profiler),
    written as a table to ``path``; returns the kernel time per call, its
    share of the call's wall time, the device time and launches per call of
    each of the port's kernels, and the kernels with the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            fn(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / 3
    events = prof.key_averages()
    key = ("self_device_time_total" if hasattr(events[0], "self_device_time_total")
           else "self_cuda_time_total")
    path.write_text(events.table(sort_by=key, row_limit=60))
    # Kernel rows only: the rows of aten ops repeat their kernels' time.
    kernels = sorted(((getattr(e, key) / 1e3 / 3, e.count // 3, e.key) for e in events
                      if getattr(e, "device_type", None) == DeviceType.CUDA), reverse=True)
    device_ms = sum(k[0] for k in kernels)
    port = {}
    for name, prefix in KERNEL_NAMES.items():
        mine = [(ms, n) for ms, n, key in kernels if prefix in key]
        if mine:
            port[name] = {"ms": sum(m for m, _ in mine), "launches": sum(n for _, n in mine)}
    return {"device_ms_per_call": device_ms, "wall_ms_per_call": wall_ms,
            "device_busy_share": device_ms / wall_ms, "port_kernels": port,
            "top_kernels": [{"ms": ms, "launches": n, "name": name[:90]}
                            for ms, n, name in kernels[:25]]}


def _native_bn_backward(g, x, gamma, mean, inv, mask):
    """One PyTorch call of the BN backward on the already-masked g (NCHW
    views of the NHWC tensors): the yardstick, used nowhere in the port."""
    return torch.ops.aten.native_batch_norm_backward(
        nchw(g), nchw(x), gamma, None, None, mean, inv, True, BN_EPS, mask)


def bn_phase(timing: bool) -> list[dict]:
    """The BN+ReLU backward kernels at the 35 regions of the training forward."""
    g = torch.Generator(device="cuda").manual_seed(4)
    rows = []
    for name, h, c in bn_region_shapes():
        gamma = torch.rand(c, device="cuda", generator=g) + 0.5
        beta = torch.rand(c, device="cuda", generator=g) - 0.5
        for dt in (torch.bfloat16, torch.float32):
            dname = str(dt).split(".")[1]
            x = (torch.randn(BATCH, h, h, c, device="cuda", generator=g) * 2 + 0.3).to(dt)
            dy = torch.randn(BATCH, h, h, c, device="cuda", generator=g).to(dt)
            y, mean, var = _fwd_math(x, gamma, beta, BN_EPS, "one_pass")
            inv = torch.rsqrt(var + BN_EPS)
            vecs = (mean, inv, gamma, beta)
            dg, db = bn_bwd_reduce(x, dy, *vecs)
            dx = bn_bwd_dx(x, dy, *vecs, dg, db)
            rdg, rdb = bn_bwd_reduce_reference(x, dy, *vecs)
            rdx = bn_bwd_dx_reference(x, dy, *vecs, rdg, rdb)
            dg2, db2 = bn_bwd_reduce(x, dy, *vecs)
            dx2 = bn_bwd_dx(x, dy, *vecs, dg2, db2)
            # With dy = 1, dβ counts each channel's unmasked elements.
            _, count = bn_bwd_reduce(x, torch.ones_like(dy), *vecs)
            positive = (y > 0).float().sum(dim=(0, 1, 2))
            torch.cuda.synchronize()
            row = {"region": name, "shape": f"{h}x{h}x{c}", "dtype": dname,
                   "dgamma_rel_err": rel_err(dg, rdg), "dbeta_rel_err": rel_err(db, rdb),
                   "dx_rel_err": rel_err(dx, rdx),
                   "reduce_max_abs_err": float(torch.maximum((dg - rdg).abs().max(),
                                                             (db - rdb).abs().max())),
                   "dx_max_abs_err": float((dx.float() - rdx.float()).abs().max()),
                   "mask_count_exact": bool(torch.equal(count, positive)),
                   "mask_matches_plain": bool(torch.equal(
                       relu_mask_reference(x, *vecs), y > 0)),
                   "deterministic": bool(torch.equal(dg, dg2) and torch.equal(db, db2)
                                         and torch.equal(dx, dx2))}
            bad = [k for k in ("dgamma_rel_err", "dbeta_rel_err") if row[k] > TOL_BN_SUMS[dname]]
            if row["dx_rel_err"] > TOL_BN_DX[dname]:
                bad.append("dx_rel_err")
            bad += [k for k in ("mask_count_exact", "mask_matches_plain", "deterministic")
                    if not row[k]]
            if bad or not torch.isfinite(dx).all():
                raise RuntimeError(f"bn {name} {dname}: {bad}: {row}")
            plane = x.numel() * x.element_size()
            row["reduce_bound_ms"], row["reduce_bound_by"] = bound(
                2 * plane + 6 * c * 4, 8 * x.numel(), "float32")
            row["dx_bound_ms"], row["dx_bound_by"] = bound(
                3 * plane + 6 * c * 4, 10 * x.numel(), "float32")
            if timing and dt == torch.bfloat16:
                row["reduce_ms"] = time_ms(lambda: bn_bwd_reduce(x, dy, *vecs), 30.0)
                row["dx_ms"] = time_ms(lambda: bn_bwd_dx(x, dy, *vecs, dg, db), 30.0)
                row["reduce_plain_ms"] = time_ms(lambda: bn_bwd_reduce_reference(x, dy, *vecs), 30.0)
                row["dx_plain_ms"] = time_ms(
                    lambda: bn_bwd_dx_reference(x, dy, *vecs, rdg, rdb), 30.0)
                gm = (dy * (y > 0)).contiguous()
                try:
                    row["reduce_library_ms"] = time_ms(lambda: _native_bn_backward(
                        gm, x, gamma, mean, inv, [False, True, True]), 30.0)
                    row["dx_library_ms"] = time_ms(lambda: _native_bn_backward(
                        gm, x, gamma, mean, inv, [True, False, False]), 30.0)
                except RuntimeError as e:
                    row["library_refused"] = str(e).splitlines()[0]
                # The torch route: autograd of relu(BN(x)) with batch statistics.
                xr = x.detach().requires_grad_()
                gr, br = gamma.detach().requires_grad_(), beta.detach().requires_grad_()
                yr = _fwd_math(xr, gr, br, BN_EPS, "one_pass")[0]
                row["torch_route_ms"] = time_ms(lambda: torch.autograd.grad(
                    yr, (xr, gr, br), dy, retain_graph=True), 30.0)
                del xr, yr, gm
            log(f"[bn] {row}")
            rows.append(row)
            del x, dy, y, dx, rdx, dx2
    return rows


def dw_train_phase() -> list[dict]:
    """The depthwise autograd Function (kernel forward, torch-op backward)
    against the torch route's autograd at one stride-1 and one stride-2 shape."""
    g = torch.Generator(device="cuda").manual_seed(6)
    rows = []
    for h, c, k, s in ((IMAGE // 2, 32, 3, 1), (IMAGE // 2, 48, 3, 2)):
        for dt in (torch.bfloat16, torch.float32):
            dname = str(dt).split(".")[1]
            x = torch.randn(BATCH, h, h, c, device="cuda", generator=g).to(dt)
            w = torch.randn(k, k, 1, c, device="cuda", generator=g) * 0.3
            cot = torch.randn(BATCH, out_size(h, k, s), out_size(h, k, s), c, device="cuda",
                              generator=g).to(dt)
            grads = []
            for route in ("kernel", "torch"):
                xr, wr = x.detach().requires_grad_(), w.detach().requires_grad_()
                fn = (lambda a, b: depthwise_conv_train(a, b, stride=s)) if route == "kernel" \
                    else (lambda a, b: depthwise_conv2d(a, b, stride=s, impl="torch"))
                grads.append(torch.autograd.grad(fn(xr, wr), (xr, wr), cot))
            (dx, dw), (tdx, tdw) = grads
            torch.cuda.synchronize()
            row = {"shape": f"{h}x{h}x{c} k{k} s{s}", "dtype": dname,
                   "dx_rel_err": rel_err(dx, tdx), "dw_rel_err": rel_err(dw, tdw),
                   "tol": TOL_DW_TRAIN[dname]}
            log(f"[dw-train] {row}")
            if (row["dx_rel_err"] > row["tol"][0] or row["dw_rel_err"] > row["tol"][1]
                    or dx.dtype != dt or dw.dtype != torch.float32):
                raise RuntimeError(f"dw training op {row['shape']} {dname} disagrees: {row}")
            rows.append(row)
    return rows


def _train_setup(dtype, route, seed=0):
    kw = {} if route == "auto" else {"dw_impl": route, "bn_bwd": route}
    model = create_model("mnasnet1_0", dtype=dtype, bn_ema="external", stem_s2d=True,
                         seed=seed, **kw)
    tx = create_optimizer("rmsprop", TRAIN_LR, fused="small")
    state = TrainState.create(model, tx, seed=seed)
    return model, state, make_train_step(model, tx, label_smoothing=0.1)


def _params(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _stats(model):
    return {n: b.clone() for n, b in model.named_buffers() if n.endswith(("mean", "var"))}


def train_phase(timing: bool, card: str, profile_dir: Path | None) -> dict:
    g = torch.Generator(device="cuda").manual_seed(5)
    images = torch.randn(BATCH, IMAGE, IMAGE, 3, device="cuda", generator=g)
    labels = torch.randint(0, 1000, (BATCH,), device="cuda", generator=g)
    model, state, step = _train_setup(torch.bfloat16, "auto")

    # The main path: counts set to 0 just before, read just after.
    for fn in COUNTERS.values():
        fn.launches = 0
    losses = []
    for _ in range(TRAIN_STEPS):
        state, metrics = step(state, images, labels)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in COUNTERS.items()}
    losses = [float(v) for v in losses]
    out = {"launches": launches, "losses": losses}
    log(f"[train] {TRAIN_STEPS} steps, losses {losses}, launches {launches}")
    if launches != {k: v * TRAIN_STEPS for k, v in LAUNCHES_PER_STEP.items()}:
        raise RuntimeError(f"expected {LAUNCHES_PER_STEP} launches per step, got {launches}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"losses not finite or not falling: {losses}")
    if model.training or state.step != TRAIN_STEPS:
        raise RuntimeError("the step left the model in train mode or miscounted steps")

    # One fp32 step on each route from the same weights (TF32 is off).
    after = {}
    for route in ("kernel", "torch"):
        m32, st32, step32 = _train_setup(torch.float32, route, seed=1)
        p0 = _params(m32)
        st32, met = step32(st32, images, labels)
        after[route] = (float(met["loss"]), p0, _params(m32), _stats(m32))
        del m32, st32, step32
    (lk, p0, pk, sk), (lt, _, pt, stt) = after["kernel"], after["torch"]
    num = sum(float(((pk[n] - pt[n]) ** 2).sum()) for n in pt)
    den = sum(float(((pt[n] - p0[n]) ** 2).sum()) for n in pt)
    outside = sum(int((~torch.isclose(pk[n], pt[n], rtol=5e-3, atol=1e-4)).sum()) for n in pt)
    fp32 = {"loss_kernel": lk, "loss_torch": lt, "loss_rel_diff": abs(lk - lt) / abs(lt),
            "update_rel_rms_diff": (num / den) ** 0.5,
            "param_max_abs_diff": max(float((pk[n] - pt[n]).abs().max()) for n in pt),
            "params_outside_rtol5e-3_atol1e-4": outside,
            "param_count": sum(p.numel() for p in pt.values()),
            "stats_max_rel_diff": max(rel_err(sk[n], stt[n]) for n in stt)}
    out["fp32_kernel_vs_torch"] = fp32
    log(f"[train] fp32 one step, kernel route vs torch route: {json.dumps(fp32)}")
    if fp32["loss_rel_diff"] > 1e-5 or fp32["stats_max_rel_diff"] > 1e-5 \
            or fp32["update_rel_rms_diff"] > 1e-2:
        raise RuntimeError(f"fp32 kernel route disagrees with the torch route: {fp32}")
    del after, p0, pk, pt, sk, stt

    if timing:
        for route in ("kernel", "torch"):
            m, st, stp = (model, state, step) if route == "kernel" else \
                _train_setup(torch.bfloat16, "torch")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            stp(st, images, labels)
            torch.cuda.synchronize()
            out[f"{route}_route_peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
            ms = time_ms(lambda: stp(st, images, labels), target_ms=2000.0)
            out[f"{route}_route_ms_per_step"] = ms
            out[f"{route}_route_images_per_s"] = BATCH / ms * 1e3
            if profile_dir is not None:
                out[f"{route}_route_profile"] = profile_forward(
                    lambda x: stp(st, x, labels), images,
                    profile_dir / f"profile_train_{route}_route.txt")
            del m, st, stp
        log(f"[train] bs{BATCH} bf16 train images/s: kernel route "
            f"{out['kernel_route_images_per_s']:.1f}, torch route "
            f"{out['torch_route_images_per_s']:.1f}; peak memory GB: kernel "
            f"{out['kernel_route_peak_memory_gb']:.2f}, torch "
            f"{out['torch_route_peak_memory_gb']:.2f} on {card}")
    return out


def _bn_entry(name, rows, serving_free_launches, replaces):
    bf = [r for r in rows if r["dtype"] == "bfloat16"]
    kind = "reduce" if name == "bn_bwd_reduce" else "dx"

    def total(key):
        return sum(r[key] for r in bf) if all(key in r for r in bf) else None

    return {"name": name, "route": "cuda", "source": "mnasnet_tpu_torch/csrc/bn_bwd.cu",
            "replaces": replaces, "launches": serving_free_launches,
            "max_abs_err": max(r[f"{kind}_max_abs_err"] for r in rows),
            "ms": total(f"{kind}_ms"), "plain_ms": total(f"{kind}_plain_ms"),
            "bound_ms": total(f"{kind}_bound_ms"),
            "bound_by": "bytes" if all(r[f"{kind}_bound_by"] == "bytes" for r in bf)
            else "operations",
            "library_ms": total(f"{kind}_library_ms"),
            "torch_route_region_ms": total("torch_route_ms"),
            "summed_over": f"{len(bf)} regions of one training step, bf16"}


def kernels_line(dw_rows, dw_step, mb_rows, serving, bn_rows, train) -> dict:
    sep = next(r for r in dw_rows if r["shape"] == "112x112x32 k3 s1" and r["dtype"] == "bfloat16")
    mb = [r for r in mb_rows if r["dtype"] == "bfloat16"]

    def total(key):
        return sum(r[key] for r in mb) if all(key in r for r in mb) else None

    by_bytes = sum(r["bound_ms"] for r in mb if r["bound_by"] == "bytes")
    paths = {"serving": serving["launches"], "train": train["launches"]}

    def by_path(name):
        return {p: launches.get(name, 0) for p, launches in paths.items()}

    def launches(name):
        return sum(by_path(name).values())

    # The training sums cover the launches one step made in the train phase.
    dw_per_step = by_path("dw_conv_bn_act")["train"] / TRAIN_STEPS
    if dw_step and dw_step["summed_over"] != dw_per_step:
        raise RuntimeError(f"the dw training sums cover {dw_step['summed_over']} launches, "
                           f"a step made {dw_per_step}")
    bn = [_bn_entry(name, bn_rows, launches(name), f"mnasnet_tpu/ops/pallas/bn_bwd.py:{line}")
          for name, line in (("bn_bwd_reduce", 57), ("bn_bwd_dx", 86))]
    for e in bn:
        e["launches_by_path"] = by_path(e["name"])
    return {"kernels": [
        {"name": "dw_conv_bn_act", "route": "cuda", "source": "mnasnet_tpu_torch/csrc/dw_conv.cu",
         "replaces": "mnasnet_tpu/ops/pallas/dw_conv.py:56",
         "also_replaces": "mnasnet_tpu/ops/pallas/dw_conv.py:96",
         "launches": launches("dw_conv_bn_act"), "launches_by_path": by_path("dw_conv_bn_act"),
         "max_abs_err": sep["max_abs_err"], "ms": sep.get("ms"), "host_ms": sep.get("host_ms"),
         "plain_ms": sep.get("plain_ms"), "bound_ms": sep["bound_ms"],
         "bound_by": sep["bound_by"], "library_ms": sep.get("library_ms"),
         "measured_at": "112x112x32 k3 s1, the serving path's one launch",
         "train_step_launches": dw_per_step,
         **{f"train_step_{key}": dw_step.get(key)
            for key in ("ms", "host_ms", "plain_ms", "library_ms", "bound_ms")},
         "shapes": dw_rows},
        {"name": "mbconv_block", "route": "cuda", "source": "mnasnet_tpu_torch/csrc/mbconv.cu",
         "replaces": "mnasnet_tpu/ops/pallas/mbconv.py:58",
         "launches": launches("mbconv_block"), "launches_by_path": by_path("mbconv_block"),
         "max_abs_err": max(r["max_abs_err"] for r in mb), "ms": total("ms"),
         "host_ms": total("host_ms"),
         "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
         "bound_by": "bytes" if by_bytes * 2 >= total("bound_ms") else "operations",
         "library_ms": None, "torch_route_ms": total("torch_route_ms"),
         "shapes": mb_rows},
        *bn,
    ]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--no-timing", action="store_true", help="run the checks only")
    ap.add_argument("--profile", type=Path, default=None, metavar="DIR",
                    help="also write torch.profiler tables of each route's forward and "
                         "train step to DIR")
    ap.add_argument("--only", choices=("all", "train", "kernels"), default="all",
                    help="'train' runs the bn, dw training and train phases only; "
                         "'kernels' the dw and mbconv phases only")
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

    def phase(name, fn, *a):
        t0 = time.perf_counter()
        result = fn(*a)
        log(f"[{name}] phase done in {time.perf_counter() - t0:.1f} s")
        return result

    if args.only in ("all", "kernels"):
        dw_rows = phase("dw", dw_phase, timing)
        dw_step = phase("dw-step", dw_train_timing) if timing else {}
        mb_rows = phase("mbconv", mbconv_phase, timing)
    if args.only == "kernels":
        log(json.dumps({"dw": dw_rows, "dw_step": dw_step, "mbconv": mb_rows}))
        log(card)
        return 0
    if args.only == "all":
        serving = phase("serving", serving_phase, timing, card, args.profile)
    bn_rows = phase("bn", bn_phase, timing)
    dw_train = phase("dw-train", dw_train_phase)
    train = phase("train", train_phase, timing, card, args.profile)

    if args.only == "all":
        log(json.dumps(kernels_line(dw_rows, dw_step, mb_rows, serving, bn_rows, train)))
        log(json.dumps({"serving": serving}))
    log(json.dumps({"train": train, "dw_train": dw_train}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
