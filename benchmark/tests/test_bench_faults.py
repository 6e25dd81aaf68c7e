"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a run
of the cell on the CPU, at a small size in float32 (so that a sound run
sits far inside the cell's limits), with the cell's own limits: once sound,
and once for each fault the cell can have, planted in the program. The
train cell takes the route it takes on the card (the port's ops, here
their CPU implementations), where a fault of the BN backward's region
lives."""

import contextlib
import time

import pytest
import torch

from benchmark.calibrate import FAULTS, fault
from benchmark.harness import run_cell

SMALL = {"arch": "mnasnet0_35", "alpha": 0.35, "image_size": 32, "compute_dtype": "float32"}
TRAIN = "train.mnasnet1_0-224.b128"
SERVE = ["serve.mnasnet1_0-224.b128", "serve.mnasnet0_5-160.b256"]


def _run(cell, traffic):
    return run_cell(cell, seed=2**31 + 77, seconds=0.5, trace=False, device=torch.device("cpu"),
                    t0=time.perf_counter(), config_overrides=SMALL, traffic_overrides=traffic,
                    log=lambda *a: None)


@pytest.fixture
def card_route(monkeypatch):
    """The program's ``auto`` routes resolved as on a CUDA tensor."""
    from mnasnet_tpu_torch.models import mnasnet
    from mnasnet_tpu_torch.ops.depthwise import resolve_impl

    monkeypatch.setattr(mnasnet, "resolve_impl",
                        lambda impl, x: "kernel" if impl == "auto" else resolve_impl(impl, x))


@pytest.mark.parametrize("kind", [None, *FAULTS])
def test_bench_train_fault(kind, card_route):
    with fault(kind) if kind else contextlib.nullcontext():
        result = _run(TRAIN, {"batch": 8, "pool_batches": 4, "warmup_seconds": 0})
    assert result["correct"] is (kind is None), result["checks"]


@contextlib.contextmanager
def served(kind):
    """The program's served logits broken where they are made: one image's
    answer altered, half of the batch left out (its rows zero), or the
    first request's answer returned for every later one."""
    from mnasnet_tpu_torch.utils import routing

    call = routing.BatchRouted.__call__
    first = {}

    def broken(self, *args):
        out = call(self, *args).clone()
        if kind == "altered":
            out[0] = out[0].flip(0)
        elif kind == "half_batch":
            out[out.shape[0] // 2:] = 0
        elif kind == "stale":
            out = first.setdefault(id(self), out)
        return out

    routing.BatchRouted.__call__ = broken
    try:
        yield
    finally:
        routing.BatchRouted.__call__ = call


@pytest.mark.parametrize("cell", SERVE)
@pytest.mark.parametrize("kind", [None, "altered", "half_batch", "stale"])
def test_bench_serve_fault(cell, kind):
    with served(kind) if kind else contextlib.nullcontext():
        result = _run(cell, {"batch": 4, "pool_batches": 4, "sample_every": 2,
                             "warmup_seconds": 0})
    assert result["correct"] is (kind is None), result["checks"]
