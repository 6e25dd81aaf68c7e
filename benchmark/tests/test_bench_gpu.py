"""On the card, at the cells' own sizes: a short run of each cell comes out
correct, and the FP8 control in the program's place does not. Skips where
there is no card."""

import time

import pytest
import torch

from benchmark import calibrate, registry
from benchmark.harness import run_cell

CELLS = [c["name"] for c in registry.manifest()["workloads"] if c["chips"] == 1]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_bench_gpu_short_run_is_correct(cell):
    device = _card()
    result = run_cell(cell, seed=2**31 + 901, seconds=2.0, trace=False, device=device,
                      t0=time.perf_counter(), log=lambda *a: None)
    assert result["correct"], result["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_bench_gpu_control_fails(cell):
    device = _card()
    c = registry.cell(cell)
    cfg, tr = registry.config(c["config"]), registry.traffic(c["traffic"])
    limits = registry.limits(cell)
    if tr["driver"] == "train_closed_loop":
        got = calibrate.train_readings(cfg, tr, 2**31 + 902, device, True, False)["control"]
    else:
        got = calibrate.serve_readings(cfg, tr, 2**31 + 902, device, True, 2.0)["control"]
    assert any(got[k] > lim["limit"] for k, lim in limits.items()), got
