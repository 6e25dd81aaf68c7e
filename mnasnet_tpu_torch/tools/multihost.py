"""Launch the ranks of one data-parallel run of the port's train CLI as
processes of their own: the counterpart of ``tools/multihost_smoke.py``'s
``_launch_multihost``, ``_common_flags`` and ``_env``.

    with Ranks(argv, world=2, work=DIR, tag="run") as ranks:
        codes = ranks.wait(timeout=600)

Each rank is ``python -m mnasnet_tpu_torch.train ARGV --dist-url
file://DIR/TAG.rendezvous --world-size N --rank R --device D``, started in
the repository's root with its own log ``DIR/TAG.rank<R>.log`` (stdout and
stderr), ``OMP_NUM_THREADS=1`` and none of torchrun's variables. ``device``
``cpu`` gives gloo ranks; ``cuda`` one card a rank (the CLI takes
``cuda:R``) over NCCL; ``cuda:0`` with ``backend="gloo"`` puts every rank
on one card. Leaving the ``with`` kills every child still running, and
every wait has a timeout.

The one-process oracle of a run of ``world`` ranks is the same CLI in one
process whose train loader yields the ranks' shards of each step
concatenated in rank order (:class:`CombinedLoader`), the global batch the
ranks' sync-BN step sees as one::

    python -m mnasnet_tpu_torch.tools.multihost --oracle-world 2 [--nudge] -- ARGV

``--nudge`` moves every image by one ulp (times 1 ± 2^-23, the sign from a
seed), which measures the run's own sensitivity to rounding: the spread
that a sum taken in another order may move it by.

The tools built on it (``deadrank_probe``,
``multihost_smoke``, ``multihost_preempt``, ``multihost_data``,
``multihost_recal``, ``dress_rehearsal``) install :func:`exit_on_sigterm`,
so a tool stopped by SIGTERM also kills its children. Each takes
``--device``, default ``cuda``, and :func:`layout` turns it into the ranks'
device and backend; ``--device cpu`` runs the gloo ranks on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np

REPO = Path(__file__).resolve().parents[2]
TRAIN_MODULE = "mnasnet_tpu_torch.train"
# torchrun's variables: a child that inherits them would join torchrun's
# group instead of the one its flags name.
TORCHRUN_ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                "MASTER_PORT", "GROUP_RANK", "ROLE_RANK", "TORCHELASTIC_RUN_ID")
POLL_S = 0.05


def small_flags(synthetic_size: int = 64) -> list:
    """The CPU runs' recipe (``tools/multihost_smoke.py:_common_flags``):
    mnasnet0_35 at 32 px, 8 classes, ``synthetic_size`` synthetic images an
    epoch in global batches of 16, fp32, SGD at a constant 1e-4 (the
    classifier's init puts the first logits at O(±20), so a larger step
    would amplify the last-ulp differences between reduction orders),
    ``--deterministic``."""
    return ["--synthetic", "--deterministic", "--arch", "mnasnet0_35", "--image-size", "32",
            "--num-classes", "8", "--synthetic-size", str(synthetic_size), "--batch-size", "16",
            "--dtype", "float32", "--optimizer", "sgd", "--lr", "1e-4",
            "--lr-schedule", "constant", "--warmup-epochs", "0", "--workers", "2",
            "--print-freq", "1"]


def layout(device: str, world: int, tool: str) -> tuple[str, str]:
    """The ranks' ``--device`` and backend for a tool's ``--device``: gloo on
    the CPU; on ``cuda`` NCCL with one card a rank where there are at least
    ``world`` cards, else gloo with every rank on ``cuda:0``. Without a card
    ``cuda`` exits 2 and says so: nothing carries on on the CPU."""
    import torch

    if torch.device(device).type != "cuda":
        return device, "gloo"
    if not torch.cuda.is_available():
        print(f"{tool}: no CUDA device for --device {device!r}; --device cpu runs it on "
              "the CPU", file=sys.stderr)
        raise SystemExit(2)
    if torch.cuda.device_count() >= world:
        return "cuda", "nccl"
    return "cuda:0", "gloo"


def child_env(extra: Optional[dict] = None) -> dict:
    """This process's environment for a child: one OpenMP thread, the
    repository on the path, no torchrun variables, plus ``extra``."""
    env = {k: v for k, v in os.environ.items() if k not in TORCHRUN_ENV}
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO), *([env["PYTHONPATH"]] if env.get("PYTHONPATH") else [])])
    env.update(extra or {})
    return env


def exit_on_sigterm() -> None:
    """Turn SIGTERM into ``SystemExit``, so that ``finally`` blocks (and
    :class:`Ranks`' kill of its children) run."""
    def handler(signum, frame):
        raise SystemExit(128 + signum)

    signal.signal(signal.SIGTERM, handler)


def read(path) -> str:
    try:
        return Path(path).read_text(errors="replace")
    except OSError:
        return ""


class RunFailed(RuntimeError):
    """A child exited non-zero or outlived its timeout."""


class Ranks:
    """``world`` processes of the train CLI, one per rank (see the module's
    docstring). ``env`` is added to every rank's environment; ``rank_env(r)``
    to rank r's."""

    def __init__(self, argv: list, world: int, work, tag: str, device: str = "cpu",
                 backend: Optional[str] = None, env: Optional[dict] = None,
                 rank_env: Optional[Callable[[int], dict]] = None):
        work = Path(work).resolve()  # a file:// rendezvous needs an absolute path
        work.mkdir(parents=True, exist_ok=True)
        rendezvous = work / f"{tag}.rendezvous"
        rendezvous.unlink(missing_ok=True)  # a stale file store would not rendezvous
        self.logs = [work / f"{tag}.rank{r}.log" for r in range(world)]
        self.procs: list[subprocess.Popen] = []
        try:
            for r in range(world):
                cmd = [sys.executable, "-m", TRAIN_MODULE, *argv, "--dist-url",
                       f"file://{rendezvous}", "--world-size", str(world), "--rank", str(r),
                       "--device", device, *(["--dist-backend", backend] if backend else [])]
                with open(self.logs[r], "w") as log:
                    self.procs.append(subprocess.Popen(
                        cmd, cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
                        env=child_env({**(env or {}), **(rank_env(r) if rank_env else {})})))
        except BaseException:
            self.close()
            raise

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def read(self, rank: int) -> str:
        return read(self.logs[rank])

    def wait(self, timeout: float) -> list:
        """Wait for every rank, at most ``timeout`` seconds in all; raise
        :class:`RunFailed` with the logs' tails unless all exit 0."""
        deadline = time.monotonic() + timeout
        codes = []
        for p in self.procs:
            try:
                codes.append(p.wait(timeout=max(deadline - time.monotonic(), 0.0)))
            except subprocess.TimeoutExpired:
                self.close()
                codes = [p.returncode for p in self.procs] + ["timeout"]
                break
        if any(c != 0 for c in codes):
            tails = "".join(f"\n--- rank {r} ---\n{self.read(r)[-3000:]}"
                            for r in range(len(self.procs)))
            raise RunFailed(f"the ranks exited {codes}{tails}")
        return codes

    def close(self) -> None:
        """Kill every child still running, and reap them all."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()  # a stopped (SIGSTOP) child dies of it too
        for p in self.procs:
            p.wait()


def pair(argv: list, outdir, work, tag: str, device: str = "cpu", timeout: float = 900.0,
         env: Optional[dict] = None, backend: Optional[str] = None) -> list:
    """Two ranks of the train CLI (``argv`` plus ``--output-dir outdir``),
    run to their end; their logs."""
    with Ranks([*argv, "--output-dir", str(outdir)], 2, work, tag, device, backend,
               env=env) as ranks:
        ranks.wait(timeout)
        return [ranks.read(r) for r in range(2)]


def finish(out: dict, path: str) -> int:
    """Write a tool's result ``out`` as JSON to ``path`` and print it; the
    tool's exit code: 0 when ``out["ok"]``, else 1."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
        f.write("\n")
    print(json.dumps(out, indent=2))
    return 0 if out["ok"] else 1


def wait_until(ready: Callable[[], bool], procs: list, timeout: float, what: str) -> None:
    """Poll ``ready`` until it holds; raise :class:`RunFailed` if every
    process of ``procs`` has exited first or ``timeout`` seconds pass."""
    deadline = time.monotonic() + timeout
    while not ready():
        if all(p.poll() is not None for p in procs):
            raise RunFailed(f"every rank exited ({[p.returncode for p in procs]}) before "
                            f"{what}")
        if time.monotonic() > deadline:
            raise RunFailed(f"{what} did not happen within {timeout:.0f} s")
        time.sleep(POLL_S)


def run_one(argv: list, log, timeout: float, device: str = "cpu",
            env: Optional[dict] = None, module: str = TRAIN_MODULE) -> str:
    """One process of ``python -m module ARGV --device D`` (no group), its
    output to ``log``; raises :class:`RunFailed` unless it exits 0 within
    ``timeout`` seconds. Returns its output."""
    cmd = [sys.executable, "-m", module, *argv, "--device", device]
    with open(log, "w") as f:
        p = subprocess.Popen(cmd, cwd=REPO, stdout=f, stderr=subprocess.STDOUT,
                             env=child_env(env))
        try:
            rc = p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            rc = "timeout"
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
    if rc != 0:
        raise RunFailed(f"{' '.join(cmd[2:])} exited {rc}:\n{read(log)[-3000:]}")
    return read(log)


def payload(outdir, key: Optional[int] = None) -> dict:
    """The checkpoint under ``key`` (default the latest) of ``outdir``."""
    import torch

    from mnasnet_tpu_torch.train.checkpoint import FILE, CheckpointManager

    key = CheckpointManager(str(outdir)).latest_epoch() if key is None else key
    return torch.load(Path(outdir) / str(key) / FILE, map_location="cpu", weights_only=True)


def bitwise_diff(a, b, path: str = "") -> list:
    """The leaves of two nested checkpoint trees that differ, bit for bit."""
    import torch

    if isinstance(a, dict):
        if a.keys() != b.keys():
            return [f"{path} (keys)"]
        return [d for k in a for d in bitwise_diff(a[k], b[k], f"{path}/{k}")]
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return [f"{path} (length)"]
        return [d for i, (x, y) in enumerate(zip(a, b)) for d in bitwise_diff(x, y, f"{path}/{i}")]
    if torch.is_tensor(a):
        same = torch.is_tensor(b) and a.dtype == b.dtype and torch.equal(a, b)
    else:
        same = a == b
    return [] if same else [path]


def state_diff(a: dict, b: dict) -> list:
    """:func:`bitwise_diff` of the model, the optimizer and the train state
    (step and dropout generator) of two checkpoints."""
    return [d for k in ("model", "optimizer", "train_state") for d in bitwise_diff(a[k], b[k], k)]


class CombinedLoader:
    """The global batches of a run of ``len(loaders)`` ranks, whose loaders
    (shards ``0..N-1``) are given: each step yields the shards' batches
    concatenated in rank order. ``nudge`` moves every image by one ulp, the
    sign drawn per (epoch, step) from a generator seeded by ``nudge``."""

    def __init__(self, loaders: list, nudge: Optional[int] = None):
        self.loaders = loaders
        self.nudge = nudge
        self.drop_last = loaders[0].drop_last
        self.batch_size = sum(loader.batch_size for loader in loaders)

    @property
    def fallback_count(self) -> int:
        return sum(loader.fallback_count for loader in self.loaders)

    def steps_per_epoch(self) -> int:
        return self.loaders[0].steps_per_epoch()

    def epoch(self, epoch: int = 0, start_step: int = 0):
        for i, parts in enumerate(zip(*(loader.epoch(epoch, start_step=start_step)
                                        for loader in self.loaders))):
            images = np.concatenate([p[0] for p in parts])
            labels = np.concatenate([p[1] for p in parts])
            if self.nudge is not None:
                rng = np.random.default_rng((self.nudge, epoch, start_step + i))
                sign = rng.integers(0, 2, images.shape).astype(np.float32) * 2 - 1
                images = images * (1 + np.float32(2.0 ** -23) * sign)
            yield images, labels


def oracle(argv: list, world: int, nudge: bool = False) -> None:
    """The train CLI's ``main(argv)`` in this process, one process, with its
    train loader the :class:`CombinedLoader` of ``world`` ranks' shards (the
    val loader stays the one process's)."""
    from mnasnet_tpu_torch.train import __main__ as train_cli

    build = train_cli.build_loaders

    def combined(args, seed, _world, _rank, say=print):
        shards = [build(args, seed, world, r, say)[0] for r in range(world)]
        return CombinedLoader(shards, 12 if nudge else None), build(args, seed, 1, 0, say)[1]

    train_cli.build_loaders = combined
    try:
        train_cli.main(argv)
    finally:
        train_cli.build_loaders = build


def run_oracle(argv: list, world: int, log, timeout: float, nudge: bool = False,
               device: str = "cpu") -> str:
    """:func:`oracle` in a process of its own; returns its output."""
    return run_one(["--oracle-world", str(world), *(["--nudge"] if nudge else []), "--",
                    *argv], log, timeout, device, module="mnasnet_tpu_torch.tools.multihost")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    sep = argv.index("--") if "--" in argv else len(argv)
    ap = argparse.ArgumentParser(
        usage="python -m mnasnet_tpu_torch.tools.multihost --oracle-world N [--nudge] "
              "-- <train args...>")
    ap.add_argument("--oracle-world", type=int, required=True)
    ap.add_argument("--nudge", action="store_true")
    args = ap.parse_args(argv[:sep])
    oracle(argv[sep + 1:], args.oracle_world, args.nudge)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
