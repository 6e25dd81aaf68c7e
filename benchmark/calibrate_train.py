"""The readings that the limits of the EfficientNet train cell are set
from, on the card.

    python3 -m benchmark.calibrate_train --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 1,2] [--fault-seeds 1] [--out FILE]

``calibrate.py``'s readings for the drivers it does not know: for each seed
the numbers the run compares, of the program against the reference and of
the reference rounded to bfloat16 at the program's points; for each control
seed those of the FP8 control; for each fault seed those of the program
broken underneath, each fault of the cell. The readings go to ``--out`` as
JSON and, one line each, to standard output.

The EfficientNet cell's faults are ``calibrate.FAULTS`` (``bn_leaves`` on
its smallest planes, 12 rows at 380 px) and three of its own:
``silu_as_relu`` (the BN regions' activation ReLU where it is SiLU),
``sd_ignored`` (the blocks' stochastic-depth mask ignored, every residual
branch kept) and ``se_gate_one`` (the squeeze-and-excitation's gate fixed
at one).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

from benchmark import calibrate, common, counting_efficientnet, registry
from benchmark.drivers import train_closed_loop_efficientnet as effnet_driver

EFFICIENTNET_FAULTS = calibrate.FAULTS + ("silu_as_relu", "sd_ignored", "se_gate_one")


@contextlib.contextmanager
def efficientnet_fault(kind: str, cfg: dict):
    """The program's EfficientNet train step broken underneath: a fault of
    ``calibrate.fault`` (``bn_leaves`` on the configuration's smallest
    planes), or ``silu_as_relu``, ``sd_ignored``, ``se_gate_one``."""
    from mnasnet_tpu_torch.models import efficientnet as eff
    from mnasnet_tpu_torch.models.layers import SqueezeExcitation

    if kind in calibrate.FAULTS:
        small = calibrate.SMALL_PLANE
        if kind == "bn_leaves":
            calibrate.SMALL_PLANE = min(h for _, h, _ in
                                        counting_efficientnet.bn_region_shapes(cfg))
        try:
            with calibrate.fault(kind):
                yield
        finally:
            calibrate.SMALL_PLANE = small
        return
    if kind == "silu_as_relu":
        owner, name = eff, "_bn_act"
        broken = lambda bn, x, region: (bn.relu_train_region(x) if region  # noqa: E731
                                        else torch.relu(bn(x)))
    elif kind == "sd_ignored":
        owner, name, forward = eff.MBConv, "forward", eff.MBConv.forward
        broken = lambda self, x, keep, region, impl: forward(self, x, None, region,  # noqa: E731
                                                             impl)
    elif kind == "se_gate_one":  # the gate's parameters stay in the step, with no gradient
        owner, name, forward = SqueezeExcitation, "forward", SqueezeExcitation.forward
        broken = lambda self, x: x + 0.0 * forward(self, x)  # noqa: E731
    else:
        raise ValueError(kind)
    saved = getattr(owner, name)
    setattr(owner, name, broken)
    try:
        yield
    finally:
        setattr(owner, name, saved)


def efficientnet_readings(cfg, tr, seed, device, control: bool, faults: bool) -> dict:
    """``calibrate.train_readings`` for the EfficientNet driver."""
    t = time.perf_counter()
    cell = effnet_driver.TrainCell(cfg, tr, seed, device)
    ours = cell.checked_steps()
    setup = time.perf_counter() - t
    cell.free_program()
    t = time.perf_counter()
    ref = cell.reference()
    wit = cell.reference(quant="bf16")
    out = {"program": calibrate.readings(ours, ref), "setup_s": setup,
           "reference_s": time.perf_counter() - t,
           "losses": {"program": ours["losses"], "reference": ref["losses"]},
           "bf16_reference": calibrate.readings(wit, ref)}
    if control:
        out["control"] = calibrate.readings(cell.reference(quant="fp8"), ref)
    del cell
    if faults:
        for kind in EFFICIENTNET_FAULTS:
            with efficientnet_fault(kind, cfg):
                cell = effnet_driver.TrainCell(cfg, tr, seed, device)
                broken = cell.checked_steps()
                cell.free_program()
            out[kind] = calibrate.readings(broken, ref)
            del cell
            common.release(device)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.calibrate_train",
                                description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate_train: needs a CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    cell = registry.cell(args.workload)
    cfg, tr = registry.config(cell["config"]), registry.traffic(cell["traffic"])
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    faults = {int(s) for s in args.fault_seeds.split(",") if s}
    rows = {}
    for seed in sorted(set(seeds) | control | faults):
        rows[seed] = efficientnet_readings(cfg, tr, seed, device, seed in control, seed in faults)
        print(json.dumps({"seed": seed, **rows[seed]}), flush=True)
    result = {"workload": args.workload, "card": common.card_line(0), "torch": torch.__version__,
              "readings": rows}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
