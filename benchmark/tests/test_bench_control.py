"""The control, the reference computed in FP8 in the program's place, comes
out not correct under each cell's limits, at a size a CPU test holds (on
the card, at the cells' own sizes: ``test_bench_gpu.py``)."""

import pytest
import torch

from benchmark import registry
from benchmark.drivers import serve_closed_loop, train_closed_loop
from benchmark.reference import mnasnet_b1 as reference
from benchmark import weights

SMALL = {"arch": "mnasnet0_35", "alpha": 0.35, "image_size": 64}


def _fails(cell: str, got: dict) -> bool:
    return any(got[k] > lim["limit"] for k, lim in registry.limits(cell).items())


def test_bench_control_fails_the_train_cell():
    cell = "train.mnasnet1_0-224.b128"
    cfg = {**registry.config("mnasnet1_0-224"), **SMALL}
    tr = {**registry.traffic("train.b128"), "batch": 16, "pool_batches": 3}
    train = train_closed_loop.TrainCell(cfg, tr, 2**31 + 3, torch.device("cpu"))
    train.free_program()  # the control takes the program's place
    ref = train.reference()
    assert _fails(cell, train_closed_loop.gaps(train.reference(quant="fp8"), ref))
    assert not _fails(cell, train_closed_loop.gaps(ref, ref))


@pytest.mark.parametrize("cell", ["serve.mnasnet1_0-224.b128", "serve.mnasnet0_5-160.b256"])
def test_bench_control_fails_the_serve_cells(cell):
    c = registry.cell(cell)
    cfg = {**registry.config(c["config"]), **SMALL}
    sd = weights.make_state_dict(cfg, 2**31 + 4, "cpu")
    images = torch.randint(0, 256, (8, 64, 64, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(4))
    ref = reference.serve_logits(sd, cfg, images)
    ctl = reference.serve_logits(sd, cfg, images, quant="fp8")
    assert _fails(cell, serve_closed_loop.gaps({0: ctl}, {0: ref}))
    assert not _fails(cell, serve_closed_loop.gaps({0: ref}, {0: ref}))
