"""The readings that a cell's limits are set from, on the card.

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] [--seconds 1] [--out FILE]

For each seed: the cell's set-up and, for a serving cell, a short window at
its own load, then the numbers the run compares, of the program against the
reference, and the same numbers of the reference rounded to bfloat16 at the
program's points (a second witness of what the program's precision alone
gives). For each control seed the same numbers of the control: the
reference computed in FP8 (``reference/mnasnet_b1.py``'s ``quant``) in the
program's place. For each fault seed of a training cell, the numbers with
the program broken underneath, each fault of ``FAULTS``. One process runs
every seed, so that the set-up is paid once. The readings go to ``--out``
as JSON and, one line each, to standard output.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

from benchmark import common, registry
from benchmark.drivers import serve_closed_loop, train_closed_loop


# The faults a training cell can have, planted in the program.
FAULTS = ("half_batch", "unchanged", "ema_unchanged", "bn_leaves")
# ``bn_leaves`` breaks the BN+ReLU regions on planes of at most this many rows.
SMALL_PLANE = 7


@contextlib.contextmanager
def fault(kind: str):
    """The program's train step broken underneath, for the life of the
    context: ``half_batch`` (the loss and its gradients of half the batch,
    the mean taken over it), ``unchanged`` (a step that updates nothing),
    ``ema_unchanged`` (the BN running statistics' EMA keeps the old ones)
    or ``bn_leaves`` (the BN backward's dgamma and dbeta counted twice on
    the planes of ``SMALL_PLANE`` rows or fewer, dx left right)."""
    from mnasnet_tpu_torch.ops.cuda import bn_bwd as bn_mod
    from mnasnet_tpu_torch.train import steps

    parts = steps._StepParts
    saved = {name: getattr(parts, name) for name in ("forward_loss", "update")}
    saved_ema, saved_bn = steps.fused_ema_stats, bn_mod.bn_bwd
    if kind == "half_batch":
        def forward_loss(self, x, y, keep, total):
            half = x.shape[0] // 2
            loss, logits = saved["forward_loss"](self, x[:half], y[:half],
                                                 None if keep is None else keep[:half], total)
            return loss, torch.cat([logits, logits])

        parts.forward_loss = forward_loss
    elif kind == "unchanged":
        parts.update = lambda self, grads, old, new: [torch.zeros_like(p) for p in self.params]
    elif kind == "ema_unchanged":
        steps.fused_ema_stats = lambda old, batch, decay: old
    elif kind == "bn_leaves":
        def twice_on_small_planes(x, *args, **kwargs):
            dx, dg, db = saved_bn(x, *args, **kwargs)
            return (dx, 2 * dg, 2 * db) if x.shape[1] <= SMALL_PLANE else (dx, dg, db)

        bn_mod.bn_bwd = twice_on_small_planes
    else:
        raise ValueError(kind)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(parts, name, fn)
        steps.fused_ema_stats, bn_mod.bn_bwd = saved_ema, saved_bn


def the_look(ours: dict, ref: dict) -> dict:
    """Where each parameter gap comes from: the five worst leaves with their
    gaps, the 80th and 95th percentiles beside the 90th, and the BN groups'
    gaps on every plane."""
    counted = train_closed_loop.counted_leaves(ref)
    out = {}
    for key in ("grad", "change"):
        by_leaf = common.leaf_gaps(ours[key], ref[key], counted)
        out[f"{key}_worst"] = sorted(by_leaf.items(), key=lambda kv: -kv[1])[:5]
        for q in (80, 95):
            out[f"{key}_gap_p{q}"] = common.percentile(by_leaf.values(), q)
        out[f"{key}_bn_planes"] = {f"{rows}.{kind}": gap for (rows, kind), gap in
                                   train_closed_loop.bn_plane_gaps(ours, ref, key).items()}
    return out


def readings(ours: dict, ref: dict) -> dict:
    return {**train_closed_loop.gaps(ours, ref), **the_look(ours, ref)}


def train_readings(cfg, tr, seed, device, control: bool, faults: bool) -> dict:
    t = time.perf_counter()
    cell = train_closed_loop.TrainCell(cfg, tr, seed, device)
    ours = cell.checked_steps()
    setup = time.perf_counter() - t
    cell.free_program()
    t = time.perf_counter()
    ref = cell.reference()
    wit = cell.reference(quant="bf16")
    out = {"program": readings(ours, ref),
           "setup_s": setup, "reference_s": time.perf_counter() - t,
           "losses": {"program": ours["losses"], "reference": ref["losses"]},
           "bf16_reference": readings(wit, ref)}
    norms = {"program": ours, "reference": ref, "bf16_reference": wit}
    if control:
        norms["control"] = cell.reference(quant="fp8")
        out["control"] = readings(norms["control"], ref)
    del cell
    if faults:
        for kind in FAULTS:
            with fault(kind):
                cell = train_closed_loop.TrainCell(cfg, tr, seed, device)
                norms[kind] = cell.checked_steps()
                cell.free_program()
            out[kind] = readings(norms[kind], ref)
            del cell
    # Every leaf's norms, for a look at the gaps leaf by leaf.
    out["norms"] = {side: {k: v for k, v in got.items() if k in ("grad", "change", "stats")}
                    for side, got in norms.items()}
    out["norms"]["planes"] = ref["planes"]
    return out


def serve_readings(cfg, tr, seed, device, control: bool, seconds: float) -> dict:
    t = time.perf_counter()
    cell = serve_closed_loop.ServeCell(cfg, tr, seed, device)
    setup = time.perf_counter() - t
    w = cell.window(seconds)
    cell.free_program()
    t = time.perf_counter()
    refs = {i: cell.reference_logits(i) for i in w["kept"]}
    wit = {i: cell.reference_logits(i, quant="bf16") for i in w["kept"]}
    out = {"program": serve_closed_loop.gaps(w["kept"], refs), "setup_s": setup,
           "reference_s": time.perf_counter() - t, "checked_requests": len(refs),
           "requests": w["requests"], "bf16_reference": serve_closed_loop.gaps(wit, refs)}
    if control:
        ctl = {i: cell.reference_logits(i, quant="fp8") for i in w["kept"]}
        out["control"] = serve_closed_loop.gaps(ctl, refs)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.calibrate",
                                description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    cell = registry.cell(args.workload)
    cfg, tr = registry.config(cell["config"]), registry.traffic(cell["traffic"])
    seeds = [int(s) for s in args.seeds.split(",")]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    faults = {int(s) for s in args.fault_seeds.split(",") if s}
    rows = {}
    for seed in sorted(set(seeds) | control | faults):
        if tr["driver"] == "train_closed_loop":
            row = train_readings(cfg, tr, seed, device, seed in control, seed in faults)
        else:
            row = serve_readings(cfg, tr, seed, device, seed in control, args.seconds)
        rows[seed] = row
        print(json.dumps({"seed": seed, **{k: v for k, v in row.items() if k != "norms"}}),
              flush=True)
    result = {"workload": args.workload, "card": common.card_line(0), "torch": torch.__version__,
              "readings": rows}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
