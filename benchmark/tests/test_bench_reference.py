"""The plain reference against the program's CPU path at a small size, and
the benchmark's weights against the program's layout."""

import pytest
import torch

from benchmark import common, registry, weights
from benchmark.drivers.train_closed_loop import TrainCell, gaps
from benchmark.reference import mnasnet_b1 as reference

SMALL = {"arch": "mnasnet0_35", "alpha": 0.35, "image_size": 64, "compute_dtype": "float32"}
CONFIG = registry.config("mnasnet1_0-224")


@pytest.mark.parametrize("arch,alpha", [("mnasnet0_35", 0.35), ("mnasnet0_5", 0.5),
                                        ("mnasnet1_0", 1.0), ("mnasnet1_4", 1.4)])
def test_bench_weights_in_the_programs_layout(arch, alpha):
    from mnasnet_tpu_torch import create_model
    from mnasnet_tpu_torch.train.optim import wd_mask

    model = create_model(arch, device="cpu")
    own = model.state_dict()
    cfg = {**CONFIG, "alpha": alpha}
    sd = weights.make_state_dict(cfg, 2**31 + 5, "cpu")
    assert list(sd) == list(own)
    assert all(sd[k].shape == own[k].shape and sd[k].dtype == own[k].dtype for k in own)
    assert weights.decayed(cfg) == wd_mask(model)
    again = weights.make_state_dict(cfg, 2**31 + 5, "cpu")
    assert all(torch.equal(sd[k], again[k]) for k in sd)


def test_bench_reference_serves_as_the_program_does():
    from mnasnet_tpu_torch.tools.export_serving import build_forward

    cfg = {**CONFIG, "alpha": 0.35}
    sd = weights.make_state_dict(cfg, 7, "cpu")
    fwd, _ = build_forward("mnasnet0_35", 1000, "float32", sd, 64, 4, dw_impl="kernel",
                           raw_input=True, device="cpu")
    images = torch.randint(0, 256, (4, 64, 64, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ours = fwd(images)
    ref = reference.serve_logits(sd, cfg, images)
    assert common.row_gap(ours, ref) < 1e-4
    # bf16 rounding moves the logits, FP8 rounding many times more.
    bf16 = common.row_gap(reference.serve_logits(sd, cfg, images, quant="bf16"), ref)
    fp8 = common.row_gap(reference.serve_logits(sd, cfg, images, quant="fp8"), ref)
    assert 1e-4 < bf16 and 3 * bf16 < fp8


def test_bench_reference_trains_as_the_program_does():
    """One step of the program's train step in float32 on the CPU against
    the reference's: the loss, the gradient as the optimizer got it, the
    parameters' and the BN running statistics' change."""
    cfg = {**CONFIG, **SMALL}
    tr = {**registry.traffic("train.b128"), "batch": 8, "pool_batches": 2, "checked_steps": 1}
    cell = TrainCell(cfg, tr, 11, torch.device("cpu"))
    ours = cell.checked_steps()
    cell.free_program()
    g = gaps(ours, cell.reference())
    assert g["loss_gap"] < 1e-5
    assert g["grad_gap"] < 5e-3 and g["change_gap"] < 5e-3
    assert g["grad_gap_median"] < 1e-3 and g["change_gap_median"] < 1e-3
    assert set(ours["stats"]) == {n for n in cell.sd if n.endswith(("running_mean",
                                                                     "running_var"))}
    assert g["stat_gap"] < 1e-3 and g["stat_gap_median"] < 1e-4
