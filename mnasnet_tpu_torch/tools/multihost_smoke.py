"""Two real ranks of the port's train CLI against themselves, a resume and
one process: the counterpart of ``tools/multihost_smoke.py``.

    python -m mnasnet_tpu_torch.tools.multihost_smoke [--out build/multihost_smoke.json]

On the small synthetic recipe (``tools/multihost.py:small_flags``,
``--deterministic``, gloo on the CPU):
  1. two ranks train ``--epochs`` epochs, twice: the final checkpoints must
     be equal bit for bit (model, optimizer, step and dropout generator);
  2. two ranks train one epoch, then two ranks ``--resume`` its checkpoint
     and train to ``--epochs``: bit for bit the uninterrupted run;
  3. one step of two ranks against one process on the same global batch
     (``multihost.oracle``: the two shards concatenated in rank order): the
     sums of sync-BN and of the gradients are taken in another grouping, so
     bitwise is not expected. Every value of the model after the step
     (parameters and BN statistics) is held to rtol 1e-5 and atol 1e-6
     plus SPREAD (25) times the one-process step's own move when its
     images move by one ulp, the bound ``tests/test_torch_parallel.py``
     holds the sync-BN step to. One step, as the reference's
     one-step pair: at the recipe's random init (first logits O(±20)) the
     run is chaotic, and after 8 steps its own one-ulp move is of the size
     of the weights (measured on the CPU: 0.21 against weights of 0.37).
Writes a JSON (``ok`` and each check) and exits 1 when it is not ok.
"""

from __future__ import annotations

import argparse
import shutil
import tempfile
from pathlib import Path

import torch

from mnasnet_tpu_torch.tools import multihost
from mnasnet_tpu_torch.tools.multihost import pair

EPOCHS = 2
SPREAD = 25.0  # tests/test_torch_parallel.py's multiple of the one-ulp move
RTOL, ATOL = 1e-5, 1e-6


def held_to_spread(ours: dict, ref: dict, moved: dict, spread: float = SPREAD) -> dict:
    """Each floating tensor of ``ours`` against ``ref`` within rtol 1e-5,
    atol 1e-6 plus ``spread`` times |moved - ref|; the others exactly.
    "max_excess" is the largest amount by which a value exceeds its bound
    (<= 0: held)."""
    worst, largest, bitwise, exact_bad = float("-inf"), 0.0, 0, []
    for name, r in ref.items():
        o, m = ours[name], moved[name]
        if not r.is_floating_point():
            if not torch.equal(o, r):
                exact_bad.append(name)
            continue
        r64, o64, m64 = r.double(), o.double(), m.double()
        diff = (o64 - r64).abs()
        bound = ATOL + RTOL * r64.abs() + spread * (m64 - r64).abs()
        worst = max(worst, float((diff - bound).max()))
        largest = max(largest, float(diff.max()))
        bitwise += bool(torch.equal(o, r))
    return {"leaves": len(ref), "bitwise_leaves": bitwise, "max_abs_diff": largest,
            "max_excess": worst, "inexact_integer_leaves": exact_bad,
            "held": worst <= 0 and not exact_bad,
            "criterion": f"|a-b| <= {ATOL} + {RTOL}|b| + {SPREAD:g}|b_one_ulp - b|"}


def smoke(argv: list, work, epochs: int = EPOCHS, timeout: float = 900.0,
          global_batch: int = 16) -> dict:
    """``argv``'s run (global batch ``global_batch``) as set out above."""
    work = Path(work).resolve()  # the children run in the repository root
    full = [*argv, "--epochs", str(epochs)]
    one = [*argv, "--epochs", "1", "--synthetic-size", str(global_batch)]
    for tag in ("a", "b", "c", "one", "oracle", "nudged"):
        shutil.rmtree(work / tag, ignore_errors=True)  # a stale checkpoint would be restored
    print(f"[1/4] two ranks, {epochs} epochs, twice", flush=True)
    pair(full, work / "a", work, "a", timeout=timeout)
    pair(full, work / "b", work, "b", timeout=timeout)
    print(f"[2/4] two ranks, one epoch, then --resume to {epochs}", flush=True)
    pair([*argv, "--epochs", "1"], work / "c", work, "c1", timeout=timeout)
    pair([*full, "--resume", str(work / "c")], work / "c", work, "c2", timeout=timeout)
    print("[3/4] one step: two ranks, one process on the same global batch, and one "
          "process on images one ulp away", flush=True)
    pair(one, work / "one", work, "one", timeout=timeout)
    for tag, nudge in (("oracle", False), ("nudged", True)):
        multihost.run_oracle([*one, "--output-dir", str(work / tag)], 2, work / f"{tag}.log",
                             timeout, nudge)
    print("[4/4] compare the final checkpoints", flush=True)
    a, b, c, one_step, oracle, nudged = (multihost.payload(work / t) for t in (
        "a", "b", "c", "one", "oracle", "nudged"))
    rerun, resumed = multihost.state_diff(a, b), multihost.state_diff(a, c)
    vs_one = held_to_spread(one_step["model"], oracle["model"], nudged["model"])
    return {
        "ok": not rerun and not resumed and vs_one["held"],
        "n_processes": 2,
        "epochs": epochs,
        "steps": int(a["train_state"]["step"]),
        "resumed_from_epoch_checkpoint": True,
        "rerun_bitwise_identical": not rerun,
        "rerun_mismatches": rerun[:10],
        "resume_bitwise_identical": not resumed,
        "resume_mismatches": resumed[:10],
        "one_step_vs_single_process": vs_one,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(multihost.REPO / "build" / "multihost_smoke.json"))
    ap.add_argument("--workdir", default=None, help="keep the logs and checkpoints here")
    args = ap.parse_args(argv)
    multihost.exit_on_sigterm()
    with tempfile.TemporaryDirectory() as tmp:
        out = smoke(multihost.small_flags(), args.workdir or tmp)
    return multihost.finish(out, args.out)


if __name__ == "__main__":
    raise SystemExit(main())
