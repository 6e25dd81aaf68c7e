"""The production-decay rehearsal of the train smoke, run in chunks: the
settings of the reference's ``CONVERGENCE_r05_prod.json`` (mnasnet0_35 @96,
RMSProp, cosine, 384 epochs of 32 steps, BN EMA 0.9997, model EMA 0.9999,
warmup 3, recalibrated scores, an eval point every 16 epochs, a clean
re-score of 2,048 train images), each chunk a fresh process of
``mnasnet_tpu_torch.tools.train_smoke``::

    python -m mnasnet_tpu_torch.tools.prod_rehearsal --state-file S --json OUT \\
        [--chunk-epochs 96] [--max-processes N] [--device cuda] [--seed 0]

Relaunches while a chunk exits 3, at most ``--max-processes`` processes in
this call; the state file carries the run from one call to the next. Exits
with the last chunk's code: 3 when the run is not done yet, else the smoke's
(0 at the target, 1 below it)."""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

from mnasnet_tpu_torch.tools.multihost import REPO, child_env

# CONVERGENCE_r05_prod.json's "config", but for the bookkeeping flags.
PROD_ARGS = ["--arch", "mnasnet0_35", "--image-size", "96", "--optimizer", "rmsprop",
             "--lr-schedule", "cosine", "--epochs", "384", "--batch-size", "128",
             "--train-size", "4096", "--val-size", "512", "--dtype", "bfloat16",
             "--target-top1", "90", "--model-ema", "0.9999", "--grad-accum", "1",
             "--bn-momentum", "0.9997", "--warmup-epochs", "3", "--bn-recalibrate",
             "--eval-every", "16", "--train-rescore-size", "2048", "--workers", "8"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--state-file", required=True)
    ap.add_argument("--json", required=True, help="where the curve goes")
    ap.add_argument("--chunk-epochs", type=int, default=96)
    ap.add_argument("--max-processes", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0,
                    help="the smoke's --seed: init, shuffle, augmentation and dropout")
    args = ap.parse_args(argv)
    cmd = [sys.executable, "-m", "mnasnet_tpu_torch.tools.train_smoke", *PROD_ARGS,
           "--device", args.device, "--seed", str(args.seed), "--state-file", args.state_file,
           "--chunk-epochs", str(args.chunk_epochs), "--json", args.json]
    rc = 3
    for n in range(args.max_processes):
        t0 = time.perf_counter()
        rc = subprocess.run(cmd, cwd=REPO, env=child_env({"OMP_NUM_THREADS": "8"})).returncode
        print(f"[rehearsal] process {n + 1} exited {rc} after "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        if rc != 3:
            break
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
