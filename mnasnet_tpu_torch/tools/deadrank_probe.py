"""Dead-rank detection and recovery of the port's train CLI: the counterpart
of ``tools/deadrank_probe.py``.

    python -m mnasnet_tpu_torch.tools.deadrank_probe [--stall] [--device cuda]
        [--timeout S] [--out build/deadrank_probe.json]

  1. two ranks of ``python -m mnasnet_tpu_torch.train`` (``tools/multihost.py:layout``:
     on the card by default, NCCL with one card a rank on two or more cards,
     else gloo with both ranks on ``cuda:0``; gloo on the CPU with ``--device
     cpu``) train
     the small synthetic recipe with a checkpoint each epoch;
  2. once rank 0 prints a step of epoch 1 and the epoch-0 checkpoint can be
     restored (``supervise.has_checkpoint``), rank 1 is SIGKILLed: no
     handler, no goodbye; with ``--stall`` it is SIGSTOPped instead, so it
     keeps its sockets open and only the group's timeout can end the
     survivor's wait (the CPU counterpart of a replayed NCCL kernel
     spinning on a dead peer);
  3. the survivor must exit non-zero: its latency is timed from the signal;
  4. recovery: one process ``--resume``s the two ranks' checkpoint and
     finishes the run.

The ranks' timeout is ``--timeout`` seconds (``MNASNET_TPU_TORCH_DIST_TIMEOUT``;
default the port's ``DIST_TIMEOUT_S``). Writes a JSON with the reference's
keys (``ok`` needs a non-zero exit within the reference's 300 s and a
recovery that completes at least one epoch) and exits 1 when it is not ok.
"""

from __future__ import annotations

import argparse
import os
import re
import signal
import subprocess
import tempfile
import time
from pathlib import Path

from mnasnet_tpu_torch.parallel.dist import DIST_TIMEOUT_S, TIMEOUT_ENV
from mnasnet_tpu_torch.tools import multihost
from mnasnet_tpu_torch.tools.supervise import has_checkpoint

EPOCHS = 4
# The reference's bar on the survivor's exit (tools/deadrank_probe.py:141).
BAR_S = 300.0
START_S = 600.0  # the ranks' start and first epoch, before the trigger
TRIGGER = re.compile(r"Epoch: \[1\]\[")


def kill_run(argv: list, outdir: str, work, *, world: int = 2, device: str = "cpu",
             backend=None, stall: bool = False, env=None, bound_s: float = 600.0,
             start_s: float = START_S, trigger: re.Pattern = TRIGGER) -> dict:
    """``world`` ranks of the train CLI (``argv`` plus ``--output-dir
    outdir``); signal rank 1 once rank 0's log matches ``trigger`` (by
    default: a step of epoch 1) and ``outdir`` holds a checkpoint (within
    ``start_s`` seconds); wait at
    most ``bound_s`` seconds for rank 0. Returns its exit code (None: still
    running at the bound), the seconds from the signal to its exit, and its
    last line."""
    sig = signal.SIGSTOP if stall else signal.SIGKILL
    with multihost.Ranks([*argv, "--output-dir", outdir], world, work, "deadrank", device,
                         backend, env) as ranks:
        multihost.wait_until(lambda: bool(trigger.search(ranks.read(0)))
                             and has_checkpoint(outdir), ranks.procs, start_s,
                             f"rank 0's line {trigger.pattern!r} after a checkpoint")
        os.kill(ranks.procs[1].pid, sig)
        signalled = time.monotonic()
        try:
            rc = ranks.procs[0].wait(timeout=bound_s)
        except subprocess.TimeoutExpired:
            rc = None
        latency = time.monotonic() - signalled
        lines = ranks.read(0).strip().splitlines()
        return {"survivor_exit_code": rc, "detection_latency_s": latency,
                "survivor_last_line": lines[-1] if lines else "",
                "kill_signal": sig.name, "log": str(ranks.logs[0])}


def recover(argv: list, outdir: str, work, epochs: int, device: str = "cpu",
            timeout: float = 1200.0) -> dict:
    """One process ``--resume``s ``outdir`` and trains to ``epochs``."""
    text = multihost.run_one([*argv, "--epochs", str(epochs), "--output-dir", outdir,
                              "--resume", outdir], Path(work) / "recover.log", timeout, device)
    m = re.search(r"=> resumed from epoch (\d+)", text)
    return {"mode": "one process --resume of the two ranks' checkpoint",
            "resumed_from_epoch": int(m.group(1)) if m else None,
            "epochs_completed_after_recovery": len(re.findall(r"^epoch \d+:", text, re.M))}


def probe(argv: list, work, epochs: int = EPOCHS, device: str = "cpu", stall: bool = False,
          timeout: float = DIST_TIMEOUT_S, backend: str = "gloo") -> dict:
    work = Path(work).resolve()  # the children run in the repository root
    outdir = str(work / "run")
    print(f"[1/2] two ranks; {'SIGSTOP' if stall else 'SIGKILL'} rank 1 at epoch 1; the "
          "survivor must exit non-zero, not hang", flush=True)
    killed = kill_run([*argv, "--epochs", str(epochs)], outdir, work, device=device,
                      backend=backend, stall=stall, env={TIMEOUT_ENV: str(timeout)},
                      bound_s=timeout + BAR_S)
    rc, latency = killed["survivor_exit_code"], killed["detection_latency_s"]
    print(f"      the survivor exited {rc} after {latency:.1f} s", flush=True)
    print("[2/2] recovery: one process --resumes the checkpoint and finishes", flush=True)
    rec = recover(argv, outdir, work, epochs, device)
    return {
        "ok": rc not in (0, None) and latency < BAR_S and rec["resumed_from_epoch"] is not None
        and rec["epochs_completed_after_recovery"] >= 1,
        "n_processes": 2,
        "killed_rank": 1,
        "kill_signal": killed["kill_signal"],
        "survivor_exit_code": rc,
        "detection_latency_s": round(latency, 1),
        "detection_mechanism": (
            "the survivor's next gloo collective raises (a dead peer's socket is closed), "
            "the CLI prints one line and exits 1" if not stall else
            f"the group's timeout ({timeout:.0f} s) ends the survivor's gloo collective, "
            "the CLI prints one line and exits 1")
        if backend == "gloo" else
        f"NCCL: the host's deadline ends the process (one line, exit 1) once an event "
        f"behind an eager collective or a replayed step has not completed in {timeout:.0f} s",
        "survivor_last_line": killed["survivor_last_line"],
        "timeout_s": timeout,
        "device": device,
        "backend": backend,
        "reference_behavior": "dead NCCL rank hangs the job (SURVEY §5.3)",
        "recovery": rec,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(multihost.REPO / "build" / "deadrank_probe.json"))
    ap.add_argument("--workdir", default=None, help="keep the logs and checkpoints here")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: NCCL with a card a rank, or gloo on cuda:0 with "
                         "fewer cards than ranks) or cpu (gloo)")
    ap.add_argument("--stall", action="store_true", help="SIGSTOP rank 1 instead of SIGKILL")
    ap.add_argument("--timeout", type=float, default=DIST_TIMEOUT_S,
                    help="the ranks' collective timeout in seconds")
    args = ap.parse_args(argv)
    multihost.exit_on_sigterm()
    device, backend = multihost.layout(args.device, 2, "deadrank_probe")
    with tempfile.TemporaryDirectory() as tmp:
        out = probe(multihost.small_flags(), args.workdir or tmp, EPOCHS, device,
                    args.stall, args.timeout, backend)
    return multihost.finish(out, args.out)


if __name__ == "__main__":
    raise SystemExit(main())
