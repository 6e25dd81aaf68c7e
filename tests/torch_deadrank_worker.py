"""Two gloo ranks on the CPU whose peer stalls: rank 1 stops itself
(SIGSTOP) after one collective made together, so its sockets stay open and
only the group's timeout can end rank 0's next collective.
``tests/test_torch_deadrank.py`` spawns them (no JAX here: spawn imports
this module in each child) and kills the stopped rank after reading rank
0's record, ``OUT/rank0.json``: the seconds until its collective raised,
what it raised and what the replicas recorded, and the seconds ``close``
took."""

import json
import os
import signal
import time

import torch

from mnasnet_tpu_torch.parallel import CollectiveFailed, all_reduce_sum_, close, init_distributed


def stalled_peer(rank: int, rendezvous: str, out: str, timeout: float) -> None:
    torch.set_num_threads(1)
    # The rendezvous waits at most ``timeout`` too: start it once both ranks
    # are up, so that a slow start on a loaded machine cannot fail it.
    open(os.path.join(out, f"up{rank}"), "w").close()
    deadline = time.monotonic() + 120
    while not all(os.path.exists(os.path.join(out, f"up{r}")) for r in range(2)):
        if time.monotonic() > deadline:
            raise TimeoutError("the other rank did not start")
        time.sleep(0.05)
    replicas = init_distributed(f"file://{rendezvous}", 2, rank, device="cpu",
                                timeout=timeout)
    all_reduce_sum_([torch.ones(1)], replicas)
    if rank == 1:
        os.kill(os.getpid(), signal.SIGSTOP)
        return
    record = {"raised": None}
    t0 = time.monotonic()
    try:
        all_reduce_sum_([torch.ones(1)], replicas, "all_reduce (the test's)")
    except CollectiveFailed as e:
        record["raised"] = str(e)
    record["raised_after_s"] = time.monotonic() - t0
    record["failed"] = replicas.failed
    t0 = time.monotonic()
    close(replicas)
    record["close_s"] = time.monotonic() - t0
    with open(os.path.join(out, "rank0.json"), "w") as f:
        json.dump(record, f)
