"""Sweep the kernels' launch plans on the card, at the shapes of a model.

    python -m mnasnet_tpu_torch.tools.tune_plans [--arch mnasnet1_0] [--out tune.json]

For every MBConv block of the model at 224 px, batch 128, bf16, it times
each tile plan of the fused MBConv kernel (output tile, chunk width, 256 or
512 threads) that fits shared memory, checks each against the plain version,
and reports the fastest beside the one :func:`mbconv.plan` picks. For every
depthwise shape it times the dw kernel at several shared-memory budgets of
:func:`dw_conv.plan`. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from mnasnet_tpu_torch.models.mnasnet import STACKS, InvertedResidual, arch_alpha, get_depths
from mnasnet_tpu_torch.ops.cuda import dw_conv, mbconv

BATCH = 128
IMAGE = 224


def time_ms(fn, target_ms: float = 100.0) -> float:
    """Device time of one call of ``fn``, from CUDA events over many calls
    after a warm-up."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    iters = int(min(200, max(5, target_ms / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def block_shapes(alpha: float = 1.0, image: int = IMAGE):
    """(name, H, Cin, Cmid, Cout, k, stride) of the 16 MBConv blocks."""
    d = get_depths(alpha)
    hw, cin, out = image // 2, d[1], []
    for s, (k, stride, exp, repeats) in enumerate(STACKS):
        for j in range(repeats):
            st = stride if j == 0 else 1
            out.append((f"s{s}b{j}", hw, cin, cin * exp, d[2 + s], k, st))
            hw, cin = mbconv.out_size(hw, k, st), d[2 + s]
    return out


def dw_shapes(alpha: float = 1.0, image: int = IMAGE):
    """(H, C, k, stride) of every distinct depthwise conv of the model."""
    d = get_depths(alpha)
    shapes = [(image // 2, d[0], 3, 1)]
    for _, h, _, cmid, _, k, s in block_shapes(alpha, image):
        if (h, cmid, k, s) not in shapes:
            shapes.append((h, cmid, k, s))
    return shapes


def train_dw_shapes(alpha: float = 1.0, image: int = IMAGE):
    """(H, C, k, stride) of the depthwise convs of one training forward, in
    order: the separable stem's, then each block's (17 at any alpha)."""
    d = get_depths(alpha)
    return [(image // 2, d[0], 3, 1)] + [(h, cmid, k, s)
                                         for _, h, _, cmid, _, k, s in block_shapes(alpha, image)]


def bn_region_shapes(alpha: float = 1.0, image: int = IMAGE):
    """(name, H, C) of the BN+ReLU regions of one training forward, in order:
    stem, separable dw, each block's expand and dw BN, head (35 at any
    alpha)."""
    d = get_depths(alpha)
    out = [("stem_bn", image // 2, d[0]), ("sep_dw_bn", image // 2, d[0])]
    hw = image // 2
    for name, h, _, cmid, _, k, s in block_shapes(alpha, image):
        hw = mbconv.out_size(h, k, s)
        out += [(f"{name}.expand_bn", h, cmid), (f"{name}.dw_bn", hw, cmid)]
    return out + [("head_bn", hw, 1280)]


def random_block(h, cin, cmid, cout, k, s, g):
    """A block on the card with seeded weights of unit-gain scale, its
    kernel arguments and an input batch."""
    block = InvertedResidual(cin, cout, k, s, cmid // cin, dw_impl="torch").cuda().eval()
    with torch.no_grad():
        for p in block.parameters():
            if p.dim() == 4:  # conv weight: unit gain over its fan-in
                p.copy_(torch.randn(p.shape, device="cuda", generator=g)
                        * (p.shape[1] * p.shape[2] * p.shape[3]) ** -0.5)
            else:
                p.copy_(torch.rand(p.shape, device="cuda", generator=g) + 0.5)
        for bn in (block.layers[1], block.layers[4], block.layers[7]):
            bn.bias.copy_(torch.randn(bn.bias.shape, device="cuda", generator=g) * 0.1)
            bn.running_mean.copy_(
                torch.randn(bn.running_mean.shape, device="cuda", generator=g) * 0.1)
    L = block.layers
    (se, be), (sd, bd), (sp, bp) = L[1].folded(), L[4].folded(), L[7].folded()
    x = torch.randn(BATCH, h, h, cin, device="cuda", generator=g)
    args = (x, L[0].matrix(), se, be, L[3].kernel(), sd, bd, L[6].matrix(), sp, bp)
    kw = dict(kernel_size=k, stride=s, residual=block.apply_residual)
    return block, args, kw


def _launcher(args, kw, p: mbconv.Plan):
    """A call of the MBConv kernel with plan ``p`` instead of the planner's."""
    x, we, se, be, wd, sd, bd, wp, sp, bp = args
    k, s = kw["kernel_size"], kw["stride"]
    n, h, w, cin = x.shape
    cmid, cout = we.shape[1], wp.shape[1]
    we_c, wp_c = we.to(x.dtype).contiguous(), wp.to(x.dtype).contiguous()
    wd_c = wd.reshape(k, k, cmid).to(x.dtype).contiguous()
    vecs = [v.float().contiguous() for v in (se, be, sd, bd, sp, bp)]
    y = torch.empty((n, mbconv.out_size(h, k, s), mbconv.out_size(w, k, s), cout),
                    dtype=x.dtype, device=x.device)
    lib = mbconv._lib()
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        err = lib.mbconv_block(
            x.data_ptr(), we_c.data_ptr(), vecs[0].data_ptr(), vecs[1].data_ptr(),
            wd_c.data_ptr(), vecs[2].data_ptr(), vecs[3].data_ptr(), wp_c.data_ptr(),
            vecs[4].data_ptr(), vecs[5].data_ptr(), y.data_ptr(), n, h, w, cin, cmid, cout,
            k, s, int(kw["residual"]), int(x.dtype == torch.bfloat16), p.th, p.tw, p.mc,
            p.threads, stream)
        if err:
            raise RuntimeError(f"mbconv_block failed with cudaError_t {err}")
    return call, y


def sweep_mbconv(alpha: float) -> list[dict]:
    g = torch.Generator(device="cuda").manual_seed(2)
    out = []
    for name, h, cin, cmid, cout, k, s in block_shapes(alpha):
        _, args, kw = random_block(h, cin, cmid, cout, k, s, g)
        args = (args[0].to(torch.bfloat16),) + args[1:]
        with torch.no_grad():
            ref = mbconv.mbconv_reference(*args, **kw).float()
        ho = mbconv.out_size(h, k, s)
        rows = []
        for th in mbconv._edges(ho):
            for tw in mbconv._edges(ho):
                if th * tw > 256:
                    continue
                px = (mbconv._expanded_extent(h, ho, th, k, s)
                      * mbconv._expanded_extent(h, ho, tw, k, s))
                for mc in (128, 64, 32, 16, 8):
                    smem = mbconv.smem_bytes(th, tw, mc, cin, cout, k, s, 2)
                    if mc > cmid or smem > mbconv.SMEM_LIMIT:
                        continue
                    for threads in (256, 512):
                        call, y = _launcher(args, kw, mbconv.Plan(th, tw, mc, smem, px, threads))
                        call()
                        err = float((y.float() - ref).abs().max() / ref.abs().max())
                        rows.append({"th": th, "tw": tw, "mc": mc, "threads": threads,
                                     "smem": smem, "expand_px": px, "err": err,
                                     "ms": time_ms(call, target_ms=30.0)})
        p = mbconv.plan(h, h, cin, cmid, cout, k, s, 2)
        picked = next(r for r in rows
                      if (r["th"], r["tw"], r["mc"], r["threads"]) == (p.th, p.tw, p.mc, p.threads))
        best = min(rows, key=lambda r: r["ms"])
        print(f"[mbconv] {name} {h}x{h} {cin}->{cmid}->{cout} k{k} s{s}: planner "
              f"{picked['ms']:.4f} ms {p[:3]}+{p.threads}t, fastest {best['ms']:.4f} ms "
              f"({best['th']},{best['tw']},{best['mc']})+{best['threads']}t, "
              f"{len(rows)} plans, max err {max(r['err'] for r in rows):.3g}", flush=True)
        out.append({"block": name, "shape": [h, cin, cmid, cout, k, s], "planner": picked,
                     "fastest": best, "plans": rows})
    return out


def sweep_dw(alpha: float) -> list[dict]:
    g = torch.Generator(device="cuda").manual_seed(3)
    budget0 = dw_conv.SMEM_BUDGET
    out = []
    try:
        for h, c, k, s in dw_shapes(alpha):
            x = torch.randn(BATCH, h, h, c, device="cuda", generator=g).to(torch.bfloat16)
            w = torch.randn(k, k, 1, c, device="cuda", generator=g) * 0.3
            scale = torch.rand(c, device="cuda", generator=g) + 0.5
            bias = torch.randn(c, device="cuda", generator=g) * 0.1
            rows = []
            for kb in (16, 24, 32, 48, 64, 96):
                dw_conv.SMEM_BUDGET = kb * 1024
                dw_conv.plan.cache_clear()
                th, cb = dw_conv.plan(BATCH, h, h, c, k, s, 2)
                rows.append({"budget_kb": kb, "th": th, "cb": cb, "ms": time_ms(
                    lambda: dw_conv.dw_conv_bn_act(x, w, scale, bias, stride=s), 30.0)})
            print(f"[dw] {h}x{h}x{c} k{k} s{s}: " + ", ".join(
                f"{r['budget_kb']} KB {r['ms']:.4f} ms" for r in rows), flush=True)
            out.append({"shape": [h, c, k, s], "rows": rows})
    finally:
        dw_conv.SMEM_BUDGET = budget0
        dw_conv.plan.cache_clear()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mnasnet1_0")
    ap.add_argument("--out", type=Path, default=None, help="write all timings as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tune_plans needs a CUDA device")
    alpha = arch_alpha(args.arch)
    result = {"card": torch.cuda.get_device_name(0), "arch": args.arch,
              "mbconv": sweep_mbconv(alpha), "dw": sweep_dw(alpha)}
    planner = sum(b["planner"]["ms"] for b in result["mbconv"])
    fastest = sum(b["fastest"]["ms"] for b in result["mbconv"])
    print(f"[mbconv] sum over blocks: planner {planner:.4f} ms, fastest plans {fastest:.4f} ms")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result))


if __name__ == "__main__":
    main()
