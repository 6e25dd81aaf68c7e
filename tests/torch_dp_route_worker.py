"""One rank of the 2-process gloo group of tests/test_torch_dp_route.py.
Imports no JAX: the spawned workers start from this module.

Each scenario builds a ``Trainer`` on this rank's half of the step runs'
batch (``torch_parallel_worker.step_case``: mnasnet0_35, 8 classes, fp32 at
64 px, the kernel route's plain versions, external BN EMA, s2d stem, RMSProp
1e-4 ``fused="small"``, label smoothing 0.1) and takes two steps on the route
the ``Trainer`` resolves. The second step's device part runs with the
tensor methods that read a value on the host patched to raise, and the
collectives the helpers count are recorded per step.
"""

from __future__ import annotations

import contextlib
import os

import torch

import torch_parallel_worker as P
from mnasnet_tpu_torch.parallel import Replicas, close, init_distributed
from mnasnet_tpu_torch.train.optim import create_optimizer
from mnasnet_tpu_torch.train.trainer import Trainer

# The tensor methods that hand a value to the host.
HOST_READS = ("item", "tolist", "__bool__", "__float__", "__int__")

# Scenario: (Trainer keywords, model keywords).
SCENARIOS = {
    "sync": ({}, {}),
    "sync_dropout": ({}, {"dropout": 0.2, "stats": "one_pass"}),
    "local": ({"sync_bn": False}, {"dropout": 0.2, "stats": "one_pass"}),
    "accum2": ({"grad_accum": 2}, {"dropout": 0.2, "stats": "one_pass"}),
    "remat": ({}, {"dropout": 0.2, "stats": "one_pass", "remat": True}),
}


class HostRead(RuntimeError):
    """A value of a tensor was read on the host inside the device step."""


@contextlib.contextmanager
def no_host_reads():
    """Within: each method of :data:`HOST_READS` raises :class:`HostRead`."""
    saved = {name: getattr(torch.Tensor, name) for name in HOST_READS}

    def refuse(name):
        def method(self, *args, **kwargs):
            raise HostRead(f"Tensor.{name} inside the device step")
        return method

    for name in HOST_READS:
        setattr(torch.Tensor, name, refuse(name))
    try:
        yield
    finally:
        for name, method in saved.items():
            setattr(torch.Tensor, name, method)


def scenario(sd, x, y, replicas, trainer_kw: dict, model_kw: dict) -> dict:
    """Two steps through a ``Trainer``; the second's device part guarded.
    Returns the route, the collectives of each step, the first step's loss,
    parameters and BN statistics, and the guarded step's error (None)."""
    kw = dict(model_kw)
    model = P._model(sd, kw.pop("dropout", 0.0), kw.pop("stats", "two_pass"), **kw)
    trainer = Trainer(model, create_optimizer("rmsprop", 1e-4, fused="small"), device="cpu",
                      label_smoothing=0.1, print_freq=1000, replicas=replicas, **trainer_kw)
    state = trainer.create_state(0)
    parts = trainer.route._steps
    device_step, armed = parts.device_step, []

    def guarded(*args, **kwargs):
        if not armed:
            return device_step(*args, **kwargs)
        with no_host_reads():
            return device_step(*args, **kwargs)

    parts.device_step = guarded  # before the first call, which binds the route
    out = {"route": trainer.route.route, "collectives": [], "error": None,
           "predicted": trainer.collectives_per_step() - 1}
    for i in range(2):
        before = replicas.collectives
        try:
            state, metrics = trainer.route(state, x, y)
        except HostRead as e:
            out["error"] = str(e)
            break
        out["collectives"].append(replicas.collectives - before)
        if i == 0:
            out["loss"] = float(metrics["loss"])
            out["params"] = {n: p.detach().clone() for n, p in model.named_parameters()}
            out["stats"] = {n: b.clone() for n, b in model.named_buffers()
                            if n.endswith(("running_mean", "running_var"))}
            armed.append(True)
    out["steps"] = state.step
    return out


def run(rank: int, rendezvous: str, work: str) -> None:
    """Every scenario on this rank; the results go to ``rank<R>.pt``."""
    torch.set_num_threads(1)
    replicas = init_distributed(f"file://{rendezvous}", P.WORLD, rank, "gloo", "cpu")
    try:
        sd = torch.load(os.path.join(work, "weights.pt"), weights_only=True)
        images, labels = P.step_case()
        rows = slice(rank * P.STEP_BATCH // P.WORLD, (rank + 1) * P.STEP_BATCH // P.WORLD)
        x, y = images[rows], labels[rows]
        # A handle of its own for each scenario: its own counts and checks.
        out = {name: scenario(sd, x, y, Replicas(rank, P.WORLD, "cpu"), *kw)
               for name, kw in SCENARIOS.items()}
        out["backend"] = (replicas.backend, Replicas(rank, P.WORLD, "cpu").backend)
        torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    finally:
        close(replicas)
