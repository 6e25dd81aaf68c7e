"""A preemption of one rank of two, with real processes: the counterpart of
``tools/multihost_preempt.py``.

    python -m mnasnet_tpu_torch.tools.multihost_preempt [--out build/multihost_preempt.json]

On the small synthetic recipe (``tools/multihost.py:small_flags``, 8 steps
an epoch, ``--deterministic``, gloo on the CPU):
  1. control: two ranks train ``--epochs`` epochs uninterrupted;
  2. preempt: the same run, and once rank 0 prints a step of epoch 1,
     SIGTERM goes to rank 1 alone. The ranks' stop flag (an all-reduce of
     each rank's request, ``parallel/dist.py:Flag``) stops both before the
     same step, mid-epoch; both take part in the preemption checkpoint and
     exit 0. ``preempt/meta.json`` records each rank's step
     (``steps_by_rank``), which must equal the checkpoint's key and the
     step rank 0 prints;
  3. resume: two ranks ``--resume`` and train to the end, starting at that
     step;
  4. the final checkpoint equals the control's bit for bit (model,
     optimizer, step and dropout generator).
Writes a JSON (``ok`` and each check) and exits 1 when it is not ok.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import signal
import tempfile
from pathlib import Path

from mnasnet_tpu_torch.tools import multihost
from mnasnet_tpu_torch.tools.multihost import pair

EPOCHS = 3
STEPS_PER_EPOCH = 8  # 128 synthetic images in global batches of 16
TRIGGER = re.compile(r"Epoch: \[1\]\[")


def preempt(argv: list, work, epochs: int = EPOCHS, timeout: float = 900.0) -> dict:
    work = Path(work).resolve()  # the children run in the repository root
    full = [*argv, "--epochs", str(epochs)]
    ctrl, pre = work / "control", work / "preempted"
    for d in (ctrl, pre):
        shutil.rmtree(d, ignore_errors=True)
    print(f"[1/4] control: two ranks, {epochs} epochs uninterrupted", flush=True)
    pair(full, ctrl, work, "control", timeout=timeout)

    print("[2/4] preempt: SIGTERM to rank 1 alone at epoch 1", flush=True)
    with multihost.Ranks([*full, "--output-dir", str(pre)], 2, work, "preempt") as ranks:
        multihost.wait_until(lambda: bool(TRIGGER.search(ranks.read(0))), ranks.procs,
                             timeout, "rank 0's first step of epoch 1")
        os.kill(ranks.procs[1].pid, signal.SIGTERM)
        ranks.wait(timeout)
        log0 = ranks.read(0)
    m = re.search(r"preempted at global step (\d+)", log0)
    if m is None:
        raise multihost.RunFailed(f"no preemption was recorded; rank 0:\n{log0[-2000:]}")
    stop = int(m.group(1))
    meta = json.loads((pre / "preempt" / "meta.json").read_text())
    keys = sorted(int(k) for k in os.listdir(pre / "preempt") if k.isdigit())

    print("[3/4] resume: two ranks --resume the preemption checkpoint", flush=True)
    logs = pair([*full, "--resume", str(pre)], pre, work, "resume", timeout=timeout)
    m = re.search(r"resumed from preemption checkpoint: epoch (\d+) step (\d+)", logs[0])
    if m is None:
        raise multihost.RunFailed(f"the resume did not start from the preemption checkpoint; "
                                  f"rank 0:\n{logs[0][-2000:]}")
    resume_epoch, resume_step = int(m.group(1)), int(m.group(2))

    print("[4/4] compare the final checkpoints bit for bit", flush=True)
    diff = multihost.state_diff(multihost.payload(ctrl), multihost.payload(pre))
    spe = meta["steps_per_epoch"]
    agreed = meta["steps_by_rank"] == [stop, stop] and keys == [stop]
    return {
        "ok": not diff and agreed and stop % spe != 0
        and resume_epoch * spe + resume_step == stop,
        "n_processes": 2,
        "epochs": epochs,
        "steps_per_epoch": spe,
        "sigterm_to_rank": 1,
        "sync_protocol": "parallel/dist.py:Flag, an all-reduce (max) of each rank's stop "
                         "request before every step",
        "stop_step": stop,
        "steps_by_rank": meta["steps_by_rank"],
        "preempt_keys": keys,
        "resume_epoch": resume_epoch,
        "resume_step": resume_step,
        "interrupted_vs_uninterrupted": {"bitwise_match": not diff, "mismatches": diff[:10]},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(multihost.REPO / "build" / "multihost_preempt.json"))
    ap.add_argument("--workdir", default=None, help="keep the logs and checkpoints here")
    args = ap.parse_args(argv)
    multihost.exit_on_sigterm()
    with tempfile.TemporaryDirectory() as tmp:
        out = preempt(multihost.small_flags(16 * STEPS_PER_EPOCH), args.workdir or tmp)
    return multihost.finish(out, args.out)


if __name__ == "__main__":
    raise SystemExit(main())
