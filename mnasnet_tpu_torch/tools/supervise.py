"""Restart supervisor of the port's trainer: restart after a crash from the
latest checkpoint, stop on a preemption.

Counterpart of ``tools/supervise.py``::

    python -m mnasnet_tpu_torch.tools.supervise [--max-restarts N] \
        [--nproc-per-node N] -- <python -m mnasnet_tpu_torch.train args...>

  * runs ``python -m mnasnet_tpu_torch.train <args>`` as a child, or with
    ``--nproc-per-node N`` ``python -m torch.distributed.run --standalone
    --nproc_per_node N -m mnasnet_tpu_torch.train <args>`` (one process per
    card);
  * exit 0: done; any other exit (a dead peer, out of memory, a fault of
    the machine; a signal, such as the SIGABRT of NCCL's watchdog, named in
    the restart line): launch again, with ``--resume OUTPUT_DIR`` appended once
    OUTPUT_DIR holds a restorable checkpoint in the layout of
    ``train/checkpoint.py`` (a numeric epoch directory, or one under
    ``preempt/``, holding its checkpoint file) and the arguments name no
    ``--resume`` of their own; never before, since the trainer refuses a
    ``--resume`` with nothing to restore;
  * SIGTERM and SIGINT to the supervisor go on to the child (the trainer's
    preemption path saves and exits) and end the restarts: a preemption is
    a scheduled stop, not a failure to retry;
  * gives up after ``--max-restarts`` consecutive failures that each came
    within 60 s (a crash loop); an attempt that lives longer resets the
    count.

Exit code: the last child's.
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time

TRAIN_MODULE = "mnasnet_tpu_torch.train"
FAST_FAILURE_S = 60.0


def describe_exit(rc: int) -> str:
    """A child's exit code as the restart line says it: a signal by name
    (Popen gives -N for a child killed by signal N; a shell reports it as
    128 + N)."""
    for code in (-rc, rc - 128):
        if 0 < code < signal.NSIG:
            try:
                name = signal.Signals(code).name
            except ValueError:
                continue
            return f"killed by {name}" if rc < 0 else f"exited {rc} (128 + {name})"
    return f"exited {rc}"


def parse_output_dir(train_args: list) -> str:
    """The trainer's ``--output-dir`` (its default ``checkpoints``)."""
    for i, a in enumerate(train_args):
        if a == "--output-dir" and i + 1 < len(train_args):
            return train_args[i + 1]
        if a.startswith("--output-dir="):
            return a.split("=", 1)[1]
    return "checkpoints"


def _has_key(directory: str) -> bool:
    from mnasnet_tpu_torch.train.checkpoint import FILE

    return os.path.isdir(directory) and any(
        name.isdigit() and os.path.isfile(os.path.join(directory, name, FILE))
        for name in os.listdir(directory))


def has_checkpoint(outdir: str) -> bool:
    """True when ``--resume outdir`` finds something to restore: an epoch
    directory or a ``preempt/`` one holding its checkpoint file (a write in
    progress lives in a temporary directory until it is renamed into place)."""
    return _has_key(outdir) or _has_key(os.path.join(outdir, "preempt"))


def build_cmd(train_args: list, outdir: str, nproc_per_node: int = 0,
              module: str = TRAIN_MODULE) -> list:
    """The child's argv: the trainer, under ``torchrun`` when
    ``nproc_per_node`` is set, with ``--resume outdir`` appended when there
    is a checkpoint to restore and the arguments name no ``--resume``."""
    if nproc_per_node > 0:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", str(nproc_per_node), "-m", module, *train_args]
    else:
        cmd = [sys.executable, "-m", module, *train_args]
    already = any(a == "--resume" or a.startswith("--resume=") for a in train_args)
    if not already and has_checkpoint(outdir):
        cmd += ["--resume", outdir]
    return cmd


def main(argv=None, module: str = TRAIN_MODULE) -> int:
    ap = argparse.ArgumentParser(
        usage="python -m mnasnet_tpu_torch.tools.supervise [--max-restarts N] "
              "[--nproc-per-node N] -- <train args...>")
    ap.add_argument("--max-restarts", type=int, default=10,
                    help="consecutive fast (<60 s) failures before giving up (an attempt "
                         "that lives longer resets the count)")
    ap.add_argument("--nproc-per-node", type=int, default=0,
                    help="run the trainer under torchrun with this many processes, one "
                         "per card (0: one process, no torchrun)")
    argv = sys.argv[1:] if argv is None else list(argv)
    if "--" in argv:
        sep = argv.index("--")
        own, train_args = argv[:sep], argv[sep + 1:]
    else:
        own, train_args = [], argv
    args = ap.parse_args(own)
    if not train_args:
        ap.error("no trainer arguments after --")

    outdir = parse_output_dir(train_args)
    stop = {"flag": False}
    child: dict = {"proc": None}

    def forward(signum, frame):
        stop["flag"] = True
        p = child["proc"]
        if p is not None and p.poll() is None:
            p.send_signal(signum)  # reaches the trainer's preemption path

    previous = {s: signal.signal(s, forward) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        fast_failures = 0
        attempt = 0
        rc = None
        while True:
            if stop["flag"]:
                # A signal between a child's exit and the next launch: a new
                # child would train on, unaware of the preemption.
                print("[supervise] stop requested: not launching a new attempt", flush=True)
                return rc if rc is not None else 128 + signal.SIGTERM
            attempt += 1
            cmd = build_cmd(train_args, outdir, args.nproc_per_node, module)
            print(f"[supervise] attempt {attempt}: {' '.join(cmd[1:])}", flush=True)
            t0 = time.monotonic()
            child["proc"] = subprocess.Popen(cmd)
            print(f"[supervise] child pid {child['proc'].pid}", flush=True)
            rc = child["proc"].wait()
            elapsed = time.monotonic() - t0
            if rc == 0:
                print(f"[supervise] attempt {attempt} completed", flush=True)
                return 0
            if stop["flag"]:
                print(f"[supervise] stop requested; the child exited {rc}: not restarting "
                      "(a preemption is a scheduled stop)", flush=True)
                return rc
            fast_failures = fast_failures + 1 if elapsed < FAST_FAILURE_S else 0
            if fast_failures >= args.max_restarts:
                print(f"[supervise] {fast_failures} consecutive fast failures (a crash "
                      f"loop): giving up with exit {rc}", flush=True)
                return rc
            print(f"[supervise] attempt {attempt} {describe_exit(rc)} after {elapsed:.0f} s: "
                  f"restarting{' from checkpoint' if has_checkpoint(outdir) else ''}",
                  flush=True)
    finally:
        for s, handler in previous.items():
            signal.signal(s, handler)


if __name__ == "__main__":
    sys.exit(main())
