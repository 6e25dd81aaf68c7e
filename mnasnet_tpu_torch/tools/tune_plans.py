"""Sweep the kernels' launch plans on the card, at the shapes of a model.

    python -m mnasnet_tpu_torch.tools.tune_plans [--arch mnasnet1_0] [--out tune.json]

For every MBConv block of the model at 224 px, batch 128, bf16, it times
each tile plan of the fused MBConv kernel (output tile, chunk width, 256 or
512 threads) that the kernel can run; for every depthwise shape, each plan
of the dw kernel (band of output rows, channel group, strip of outputs per
thread). It checks each plan against the plain version and reports the
fastest beside the one :func:`mbconv.plan` or :func:`dw_conv.plan` picks.
Needs a CUDA device.
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


def time_ms(fn, target_ms: float = 100.0, graph: bool = False) -> float:
    """Device time of one call of ``fn``, from CUDA events over many calls
    after a warm-up. With ``graph`` the calls replay one CUDA graph of
    ``fn``, so that the host's launch overhead (tens of microseconds of
    Python per call) does not leave the card idle between short kernels."""
    for _ in range(3):
        fn()
    if graph:
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, capture_error_mode="relaxed"):
            fn()
        fn = g.replay
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


def _dw_candidates(n, h, c, k, s, eb):
    """The dw plans the sweep times: both strips, every channel group that
    divides C, bands of 7 and 14 output rows and of the whole plane, 1, 2, 4
    and 7 rows side by side, within the thread limit and 100 KB."""
    ho = wo = dw_conv.out_size(h, k, s)
    out = []
    for r in dw_conv.STRIPS:
        for cg in range(8, c + 1, 8):
            for th in sorted({min(ho, b) for b in (7, 14, ho)}):
                for rp in dw_conv.ROWS_SIDE_BY_SIDE:
                    if c % cg or rp > th or cg // 8 * -(-wo // r) * rp > dw_conv.MAX_THREADS \
                            or dw_conv.smem_bytes(k, s, wo, th, cg, r, rp, eb) > 100 * 1024:
                        continue
                    out.append(dw_conv.make_plan(n, h, h, c, k, s, eb, th, cg, r, rp))
    return out


def sweep_dw(alpha: float) -> list[dict]:
    """Every dw shape of the model, bf16, fused form (affine + ReLU): each
    plan of :func:`_dw_candidates` checked against the plain version and
    timed, beside the planner's."""
    g = torch.Generator(device="cuda").manual_seed(3)
    out = []
    for h, c, k, s in dw_shapes(alpha):
        x = torch.randn(BATCH, h, h, c, device="cuda", generator=g).to(torch.bfloat16)
        w = torch.randn(k, k, c, device="cuda", generator=g) * 0.3
        scale = torch.rand(c, device="cuda", generator=g) + 0.5
        bias = torch.randn(c, device="cuda", generator=g) * 0.1
        ref = dw_conv.dw_conv_reference(x, w, scale, bias, stride=s).float()
        rows = []
        for p in _dw_candidates(BATCH, h, c, k, s, 2):
            y = dw_conv.launch(x, w, scale, bias, s, True, p)
            err = float((y.float() - ref).abs().max() / ref.abs().max())
            if err > 2.0 ** -7:
                raise RuntimeError(f"dw plan {p} at {h}x{h}x{c} k{k} s{s}: error {err:.3g}")
            rows.append({**p._asdict(), "err": err, "ms": time_ms(
                lambda: dw_conv.launch(x, w, scale, bias, s, True, p), 30.0, graph=True)})
        pp = dw_conv.plan(BATCH, h, h, c, k, s, 2)
        picked = next(r for r in rows if (r["th"], r["cg"], r["r"], r["rp"]) == pp[:4])
        best = min(rows, key=lambda r: r["ms"])
        print(f"[dw] {h}x{h}x{c} k{k} s{s}: planner {picked['ms']:.4f} ms {tuple(pp[:4])}, "
              f"fastest {best['ms']:.4f} ms {(best['th'], best['cg'], best['r'], best['rp'])} "
              f"(th, cg, r, rp), {len(rows)} plans", flush=True)
        out.append({"shape": [h, c, k, s], "planner": picked, "fastest": best, "plans": rows})
    return out


def sweep_mbconv(alpha: float) -> list[dict]:
    """Every MBConv block of the model, bf16: each tile plan (tile, chunk
    width, 256 or 512 threads) that the kernel can run, checked against the
    plain version and timed, beside the planner's."""
    g = torch.Generator(device="cuda").manual_seed(2)
    out = []
    for name, h, cin, cmid, cout, k, s in block_shapes(alpha):
        _, args, kw = random_block(h, cin, cmid, cout, k, s, g)
        args = (args[0].to(torch.bfloat16),) + args[1:]
        with torch.no_grad():
            ref = mbconv.mbconv_reference(*args, **kw).float()
        ops = mbconv.kernel_args(*args, kernel_size=k)
        ho = mbconv.out_size(h, k, s)
        rows = []
        for th in mbconv._edges(ho):
            for tw in mbconv._edges(ho):
                if th * tw > 256:
                    continue
                px = (mbconv._expanded_extent(h, ho, th, k, s)
                      * mbconv._expanded_extent(h, ho, tw, k, s))
                for mc in mbconv._TC_CHUNKS:
                    for threads in (256, 512):
                        if not mbconv.feasible(th, tw, mc, cin, cmid, cout, k, s, 2, threads):
                            continue
                        smem = mbconv.smem_bytes(th, tw, mc, cin, cout, k, s, 2)
                        p = mbconv.Plan(th, tw, mc, smem, px, threads)

                        def call(p=p):
                            return mbconv.launch(*ops, stride=s, residual=kw["residual"], p=p)

                        err = float((call().float() - ref).abs().max() / ref.abs().max())
                        if err > 2.0 ** -6:
                            raise RuntimeError(f"mbconv plan {p} of {name}: error {err:.3g}")
                        rows.append({"th": th, "tw": tw, "mc": mc, "threads": threads,
                                     "smem": smem, "expand_px": px, "err": err,
                                     "ms": time_ms(call, 30.0, graph=True)})
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
    for kernel in ("mbconv", "dw"):
        planner = sum(b["planner"]["ms"] for b in result[kernel])
        fastest = sum(b["fastest"]["ms"] for b in result[kernel])
        print(f"[{kernel}] sum over shapes: planner {planner:.4f} ms, "
              f"fastest plans {fastest:.4f} ms")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result))


if __name__ == "__main__":
    main()
