"""Failure across the port's ranks on the CPU (gloo): a dead or stalled
peer ends the survivor within a bound, the run recovers from its
checkpoint, and the supervisor restarts a two-worker run whose worker was
killed. Real processes: the train CLI's ranks (``tools/multihost.py``),
spawned workers (``tests/torch_deadrank_worker.py``) and ``torchrun`` under
``tools/supervise.py``.

Bounds, each with its reason:
  * a SIGKILLed peer closes its sockets, so the survivor's next collective
    raises at once: exit non-zero within 60 s (measured: under 1 s);
  * a stalled (SIGSTOPped) peer keeps its sockets open, so only the
    group's timeout (10 s here) ends the wait: the survivor raises within
    the timeout plus 30 s, and ``close`` returns (it aborts the failed
    group instead of destroying it);
  * a SIGTERM (a ``torchrun`` agent's, after the other worker died) whose
    stop agreement fails: exit non-zero within 60 s, no preemption
    checkpoint.
The full-size probe (the tool's defaults, and its ``--stall`` mode at the
port's own timeout) runs only with ``RUN_SLOW`` set, as
``tests/test_multihost.py`` gates its multi-process runs.
"""

import datetime
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import torch_deadrank_worker as W
from mnasnet_tpu_torch import create_model
from mnasnet_tpu_torch.parallel import dist as pdist
from mnasnet_tpu_torch.tools import deadrank_probe, multihost, supervise
from mnasnet_tpu_torch.tools.supervise import has_checkpoint
from mnasnet_tpu_torch.train.optim import create_optimizer
from mnasnet_tpu_torch.train.trainer import Trainer

STALL_TIMEOUT_S = 10.0
KILLED_BOUND_S = 60.0
SLOW = pytest.mark.skipif(not os.environ.get("RUN_SLOW"),
                          reason="full-size multi-process probe (minutes); set RUN_SLOW=1")


def _small(epochs):
    return [*multihost.small_flags(), "--epochs", str(epochs)]


@pytest.mark.parametrize("how", ["env", "dist_url"])
def test_init_distributed_bounds_every_collective(how, monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **kw: calls.append((a, kw)))
    monkeypatch.delenv(pdist.TIMEOUT_ENV, raising=False)
    monkeypatch.delenv("TORCH_NCCL_ASYNC_ERROR_HANDLING", raising=False)
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    if how == "env":
        monkeypatch.setenv("WORLD_SIZE", "2")
        monkeypatch.setenv("RANK", "1")
        url = None
    else:
        url = f"file://{tmp_path / 'rendezvous'}"
    replicas = pdist.init_distributed(url, 2, 1, device="cpu")
    assert (replicas.rank, replicas.world) == (1, 2)
    (args, kw), = calls
    assert args == ("gloo",) and kw["init_method"] == (url or "env://")
    assert kw["timeout"] == datetime.timedelta(seconds=pdist.DIST_TIMEOUT_S)
    # the keyword, then the environment variable, shorten it
    pdist.init_distributed(url, 2, 1, device="cpu", timeout=7)
    assert calls[-1][1]["timeout"] == datetime.timedelta(seconds=7)
    monkeypatch.setenv(pdist.TIMEOUT_ENV, "11")
    pdist.init_distributed(url, 2, 1, device="cpu")
    assert calls[-1][1]["timeout"] == datetime.timedelta(seconds=11)
    # NCCL: the same bound; NCCL's own error handling is left as PyTorch
    # sets it (the host's Deadline ends the process)
    pdist.join_group("nccl", "env://", 2, 1)
    assert calls[-1][0] == ("nccl",)
    assert calls[-1][1]["timeout"] == datetime.timedelta(seconds=11)
    assert "TORCH_NCCL_ASYNC_ERROR_HANDLING" not in os.environ


class _Event:
    """A stand-in for a CUDA event that completes, never does, or whose
    query raises (a failed CUDA context)."""

    def __init__(self, done):
        self.done = done
        self.recorded = False

    def record(self):
        self.recorded = True

    def query(self):
        if self.done == "raises":
            raise RuntimeError("CUDA error: an illegal memory access was encountered")
        return self.done


@pytest.mark.parametrize("stuck", [False, True, "raises"], ids=["completes", "never", "raises"])
def test_the_host_deadline_ends_a_collective_that_never_completes(stuck, monkeypatch, capfd):
    """An NCCL group's host deadline: completed collectives are let go; one
    still incomplete past the limit, or one that cannot be queried, ends
    the process with one line."""
    monkeypatch.setattr(pdist.Deadline, "POLL_S", 0.02)
    exits = []
    deadline = pdist.Deadline(3, torch.device("cpu"), limit_s=0.2, exit=exits.append)
    try:
        deadline.issued(_Event(True), "all_reduce (gradients)")
        deadline.issued(_Event(stuck if stuck == "raises" else not stuck),
                        "all_reduce (the stop flag)")
        end = time.monotonic() + 10
        while stuck and not exits and time.monotonic() < end:
            time.sleep(0.02)
        time.sleep(0.3)
    finally:
        deadline.stop()
    err = capfd.readouterr().err
    if stuck:
        assert exits == [1]
        line = err.strip().splitlines()[-1]  # after every thread's stack
        if stuck == "raises":
            assert line == ("[rank 3] all_reduce (the stop flag) cannot be queried (CUDA "
                            "error: an illegal memory access was encountered); exiting")
        else:
            assert line.startswith("[rank 3] all_reduce (the stop flag) has not completed ")
            assert line.endswith("(a dead or stalled peer); exiting")
        assert "test_the_host_deadline_ends_a_collective" in err
    else:
        assert exits == [] and err == "" and not deadline._pending


def test_every_eager_collective_is_watched_and_the_flag_waits_for_nothing(tmp_path,
                                                                           monkeypatch):
    """With a host deadline, each collective a helper issues puts an event
    behind it (``Replicas.watch``), named; so does an explicit watch (what
    ``TrainRouted`` does after each replay). The stop flag is built on the
    device (``torch.full``), not copied from pageable host memory, which
    would wait for the stream, and a replay spinning on a dead peer, before
    the flag's event were recorded. A world-1 gloo group with a stand-in
    deadline and events."""
    class Recorded:
        def __init__(self):
            self.whats = []

        def issued(self, event, what):
            assert event.recorded
            self.whats.append(what)

        def stop(self):
            pass

    monkeypatch.setattr(torch.cuda, "Event", lambda: _Event(True))
    pdist.join_group("gloo", f"file://{tmp_path / 'rendezvous'}", 1, 0)
    replicas = pdist.Replicas(0, 1, "cpu")
    replicas.deadline = recorded = Recorded()
    made = []
    full, tensor = torch.full, torch.tensor
    monkeypatch.setattr(torch, "full", lambda *a, **kw: made.append("full") or full(*a, **kw))
    monkeypatch.setattr(torch, "tensor",
                        lambda *a, **kw: made.append("tensor") or tensor(*a, **kw))
    try:
        pdist.all_reduce_sum_([torch.ones(3)], replicas, "all_reduce (gradients)")
        assert pdist.Flag(True, replicas).get()
        made_by_flag = list(made)
        pdist.barrier(replicas)
        replicas.watch("the replayed train step")
    finally:
        pdist.close(replicas)
    assert recorded.whats == ["all_reduce (gradients)", "all_reduce (the stop flag)",
                              "all_reduce (barrier)", "the replayed train step"]
    assert made_by_flag == ["full"]


def test_survivor_of_a_killed_peer_exits_and_a_resume_finishes(tmp_path):
    """Two ranks of the train CLI; rank 1 SIGKILLed at epoch 1, after the
    epoch-0 checkpoint: rank 0 prints one line naming itself and the
    collective and exits 1; one process ``--resume``s and finishes."""
    out = deadrank_probe.probe(_small(3), tmp_path, epochs=3)
    assert out["ok"], out
    assert out["survivor_exit_code"] == 1
    assert out["detection_latency_s"] < KILLED_BOUND_S
    assert out["survivor_last_line"].startswith("[rank 0] all_reduce")
    assert "failed" in out["survivor_last_line"]
    assert out["recovery"]["resumed_from_epoch"] == 0
    assert out["recovery"]["epochs_completed_after_recovery"] == 2


def test_stalled_peer_raises_within_the_timeout_and_close_returns(tmp_path):
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=W.stalled_peer,
                         args=(r, str(tmp_path / "rendezvous"), str(tmp_path), STALL_TIMEOUT_S))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        procs[0].join(STALL_TIMEOUT_S + 30 + 30)  # + the spawn's start
        assert not procs[0].is_alive() and procs[0].exitcode == 0
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(30)
    rec = json.loads((tmp_path / "rank0.json").read_text())
    assert rec["raised"] is not None and rec["raised"].startswith(
        "rank 0: all_reduce (the test's) failed:"), rec
    assert rec["failed"] and "Timed out" in rec["failed"]
    assert STALL_TIMEOUT_S - 1 <= rec["raised_after_s"] < STALL_TIMEOUT_S + 30, rec
    assert rec["close_s"] < 10, rec


def test_sigterm_after_a_peer_died_writes_no_preempt_checkpoint(tmp_path):
    """A torchrun agent answers a dead worker with SIGTERM to the others:
    the stop must be agreed by every rank, which a dead one cannot, so the
    survivor exits non-zero with no preemption checkpoint."""
    out = tmp_path / "run"
    with multihost.Ranks([*_small(4), "--output-dir", str(out)], 2, tmp_path, "t") as ranks:
        multihost.wait_until(lambda: bool(deadrank_probe.TRIGGER.search(ranks.read(0)))
                             and has_checkpoint(str(out)), ranks.procs, 120, "epoch 1")
        ranks.procs[1].kill()
        ranks.procs[0].send_signal(signal.SIGTERM)
        rc = ranks.procs[0].wait(timeout=KILLED_BOUND_S)
        log0 = ranks.read(0)
    assert rc not in (0, None), log0[-2000:]
    assert "failed" in log0.strip().splitlines()[-1], log0[-2000:]
    assert not (out / "preempt").exists()
    assert "preempted" not in log0


def _descendants(pid):
    """The process ids under ``pid``, from /proc."""
    children = {}
    for name in os.listdir("/proc"):
        if name.isdigit():
            try:
                with open(f"/proc/{name}/stat") as f:
                    ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            except (OSError, IndexError, ValueError):
                continue
            children.setdefault(ppid, []).append(int(name))
    out, todo = [], [pid]
    while todo:
        for c in children.get(todo.pop(), []):
            out.append(c)
            todo.append(c)
    return out


def _local_rank(pid):
    try:
        with open(f"/proc/{pid}/environ", "rb") as f:
            env = f.read().split(b"\0")
    except OSError:
        return None
    return next((int(e.split(b"=", 1)[1]) for e in env if e.startswith(b"LOCAL_RANK=")), None)


def test_supervise_restarts_two_workers_after_one_is_killed(tmp_path):
    """``supervise --nproc-per-node 2`` on the CPU (torchrun, gloo): one
    worker SIGKILLed after the epoch-0 checkpoint; the other exits 1, the
    agent fails the attempt, and the supervisor relaunches with
    ``--resume`` to the end."""
    out = tmp_path / "run"
    log = tmp_path / "supervise.log"
    cmd = [sys.executable, "-m", "mnasnet_tpu_torch.tools.supervise", "--nproc-per-node", "2",
           "--", *_small(3), "--output-dir", str(out), "--device", "cpu"]
    with open(log, "w") as f:
        p = subprocess.Popen(cmd, cwd=multihost.REPO, stdout=f, stderr=subprocess.STDOUT,
                             env=multihost.child_env())
    try:
        multihost.wait_until(lambda: has_checkpoint(str(out)), [p], 120, "a checkpoint")
        worker = next(c for c in _descendants(p.pid) if _local_rank(c) == 1)
        os.kill(worker, signal.SIGKILL)
        rc = p.wait(timeout=240)
    finally:
        if p.poll() is None:
            for c in _descendants(p.pid):
                os.kill(c, signal.SIGKILL)
            p.kill()
            p.wait()
    text = log.read_text()
    assert rc == 0, text[-3000:]
    assert "[supervise] attempt 1 exited 1 after" in text and "restarting from checkpoint" in text
    assert f"--resume {out}" in text and "=> resumed from epoch 0" in text
    assert "[supervise] attempt 2 completed" in text
    assert sorted(int(k) for k in os.listdir(out) if k.isdigit())[-1] == 2


FAKE_SIGNALLED = '''
import os, signal, sys
args = sys.argv[1:]
out = args[args.index("--output-dir") + 1]
if "--resume" in args or os.path.exists(out + ".once"):
    sys.exit(0)
open(out + ".once", "w").close()
os.kill(os.getpid(), signal.SIGKILL)
'''


def test_supervise_names_the_childs_signal(tmp_path, monkeypatch, capfd):
    (tmp_path / "fake_signalled.py").write_text(FAKE_SIGNALLED)
    monkeypatch.setenv("PYTHONPATH", f"{tmp_path}:{':'.join(sys.path)}")
    rc = supervise.main(["--max-restarts", "3", "--", "--output-dir", str(tmp_path / "run")],
                        module="fake_signalled")
    assert rc == 0
    assert "[supervise] attempt 1 killed by SIGKILL after" in capfd.readouterr().out


@pytest.mark.parametrize("rc,said", [(-9, "killed by SIGKILL"), (-6, "killed by SIGABRT"),
                                     (134, "exited 134 (128 + SIGABRT)"), (1, "exited 1"),
                                     (255, "exited 255")])
def test_describe_exit(rc, said):
    assert supervise.describe_exit(rc) == said


class _Loader:
    """Three steps of 4 random 32 px images."""

    def steps_per_epoch(self):
        return 3

    def epoch(self, epoch, start_step=0):
        rng = np.random.default_rng(epoch)
        for _ in range(start_step, 3):
            yield (rng.standard_normal((4, 32, 32, 3)).astype(np.float32),
                   rng.integers(0, 8, 4).astype(np.int32))


@pytest.mark.parametrize("route", ["replay", "eager"])
def test_each_step_issues_the_eager_stop_flag_first(route, tmp_path):
    """Counted, not read from the code: on every route each step of
    ``Trainer.train_epoch`` issues exactly one collective of its own before
    the step runs, the stop flag, which the host deadline of an NCCL group
    watches. A graph replay issues the step's collectives on the device,
    uncounted (the stand-in step issues none); the eager step issues the
    step's (``steps.step_collectives``) after the flag. A world-1 gloo
    group."""
    pdist.join_group("gloo", f"file://{tmp_path / 'rendezvous'}", 1, 0)
    replicas = pdist.Replicas(0, 1, "cpu")
    try:
        model = create_model("mnasnet0_35", device="cpu", num_classes=8, bn_ema="external",
                             stem_s2d=True, seed=0)
        trainer = Trainer(model, create_optimizer("sgd", 1e-4, fused="small"), device="cpu",
                          print_freq=100, replicas=replicas)
        state = trainer.create_state(0)
        seen = []
        step = trainer._train_step

        def counted(state, images, labels):
            seen.append(replicas.collectives)
            if route == "eager":
                return step(state, images, labels)
            zero = torch.zeros(())
            return state, {"loss": zero, "top1": zero, "top5": zero, "count": zero + 4}

        trainer._train_step = counted
        trainer.train_epoch(state, _Loader(), 0)
        per_step = trainer.collectives_per_step() if route == "eager" else 1
        # the first step's check of each BN plane size: 16², 8², 4², 2², 1²
        first = 5 if route == "eager" else 0
        # before step j: the epoch's flag, then j steps and the flag of step j
        assert seen == [1 + 1 + j * per_step + (first if j else 0) for j in range(3)]
        assert replicas.collectives == 1 + 3 * per_step + first + 1  # + the epoch end's flag
    finally:
        pdist.close(replicas)
    assert not dist.is_initialized()


@SLOW
@pytest.mark.parametrize("stall", [False, True], ids=["kill", "stall"])
def test_deadrank_probe_full_size(stall, tmp_path):
    """The tool's defaults; ``--stall`` at the port's own timeout."""
    r = subprocess.run([sys.executable, "-m", "mnasnet_tpu_torch.tools.deadrank_probe",
                        "--out", str(tmp_path / "dr.json"), "--workdir", str(tmp_path),
                        *(["--stall"] if stall else [])], cwd=multihost.REPO,
                       env=multihost.child_env(), timeout=1800)
    out = json.loads((tmp_path / "dr.json").read_text())
    assert r.returncode == 0 and out["ok"], out
    bound = pdist.DIST_TIMEOUT_S + 30 if stall else KILLED_BOUND_S
    assert out["detection_latency_s"] < bound
