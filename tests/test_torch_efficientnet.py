"""EfficientNet in the port against its plain reference, on the CPU.

The model (``mnasnet_tpu_torch/models/efficientnet.py``) at its published
widths for the parameter counts and the state_dict layout, and at a reduced
width and depth at 32 px in float32 against ``benchmark/reference/
efficientnet.py`` (plain float32 PyTorch, written from the paper) for the
eval logits and three train steps, through the benchmark's own driver of
the train cell. Tolerances are float32 round-off over the small net: the
two sides sum the same numbers in other orders (one-pass against two-pass
variance, fused region sums against autograd's), so the loss agrees to
~1e-6 and each parameter's gradient and change to ~1e-4 of the median
leaf's, with the worst, ill-conditioned leaves of a 1x1 plane at batch 8 a
few times that.
"""

import contextlib
import time

import pytest
import torch

from benchmark import common, counting_efficientnet, registry
from benchmark import weights_efficientnet as weights
from benchmark.calibrate_train import efficientnet_fault
from benchmark.drivers import train_closed_loop_efficientnet as driver
from benchmark.reference import efficientnet as reference
from mnasnet_tpu_torch import create_model
from mnasnet_tpu_torch.models import efficientnet
from mnasnet_tpu_torch.train.optim import wd_mask

CELL = "train.efficientnet_b4-380.b64"
B4 = registry.config("efficientnet_b4-380")


def _small(width=0.25, depth=0.3, **kw):
    """The B4 configuration's file at another width and depth, 32 px, fp32,
    10 classes."""
    return {**counting_efficientnet.family_config(B4, width, depth), "image_size": 32,
            "compute_dtype": "float32", "arch": "efficientnet_b0", "num_classes": 10, **kw}


def _model(cfg, **kw):
    return create_model(cfg["arch"], device="cpu", num_classes=cfg["num_classes"],
                        width_mult=cfg["width_mult"], depth_mult=cfg["depth_mult"],
                        dropout=cfg["dropout"], stochastic_depth=cfg["stochastic_depth"],
                        bn_eps=cfg["bn_eps"], bn_momentum=cfg["bn_momentum"], **kw)


@pytest.mark.parametrize("arch,width,depth,params", [
    ("efficientnet_b0", 1.0, 1.0, 5_288_548), ("efficientnet_b4", 1.4, 1.8, 19_341_616)])
def test_parameter_counts_and_layout(arch, width, depth, params):
    """torchvision's parameter counts, and the state_dict names, shapes and
    decay mask of the benchmark's torchvision-layout weights."""
    model = create_model(arch, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == params
    cfg = counting_efficientnet.family_config(B4, width, depth)
    own = model.state_dict()
    spec = weights.leaves(cfg)
    assert [n for n, _, _ in spec] == list(own)
    assert all(tuple(own[n].shape) == shape for n, shape, _ in spec)
    assert weights.decayed(cfg) == wd_mask(model)
    assert len(model.blocks()) == len(counting_efficientnet.block_shapes(cfg))


@pytest.mark.parametrize("dw_impl", ["torch", "kernel"])
def test_eval_logits_match_the_reference(dw_impl):
    """Eval mode (folded BN, the dw op's SiLU epilogue on the kernel route)
    against the reference's eval logits of the same uint8 images."""
    cfg = _small()
    sd = weights.make_state_dict(cfg, 2**31 + 3, "cpu")
    model = _model(cfg, dtype=torch.float32, dw_impl=dw_impl)
    model.load_state_dict(sd)
    images = torch.randint(0, 256, (3, 32, 32, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ours = model(reference.normalize_uint8(images))
    assert common.row_gap(ours, reference.serve_logits(sd, cfg, images)) < 1e-5


def test_the_step_mask_is_the_references():
    """One uniform draw a step: the head's dropout columns, then one column
    per residual block at 1 - sd * i / n, the reference's from the same
    seed; block i takes its own column."""
    cfg = _small(depth=1.0)
    model = _model(cfg)
    assert torch.equal(model.keep_prob, reference.keep_probability(cfg))
    g = torch.Generator().manual_seed(7)
    assert torch.equal(model.dropout_keep(5, g, "cpu"),
                       reference.dropout_keep(7, 1, 5, cfg, "cpu")[0])
    residual = [b for b in model.blocks() if b.residual]
    assert [b.column for b in residual] == list(range(model.head_width,
                                                      model.head_width + len(residual)))
    assert model.keep_prob[model.head_width:].tolist() == pytest.approx(
        [1 - 0.2 * i / 16 for i, b in enumerate(model.blocks()) if b.residual])


def test_a_dropped_block_passes_its_input():
    """Stochastic depth in row mode: an image whose column is false takes
    the block's input, a kept one the branch over its keep probability."""
    cfg = _small(depth=1.0)
    model = _model(cfg).train()
    block = next(b for b in model.blocks() if b.residual and b.drop > 0)
    x = torch.randn(2, block.block[0][0].weight.shape[1], 8, 8).to(
        memory_format=torch.channels_last)
    keep = torch.ones(2, model.keep_prob.numel(), dtype=torch.bool)
    keep[1, block.column] = False
    with torch.no_grad():
        y = block(x, keep, False, "torch")
        branch = block(x, None, False, "torch") - x
    assert torch.equal(y[1], x[1])
    torch.testing.assert_close(y[0], x[0] + branch[0] / (1 - block.drop))


@pytest.fixture
def card_route(monkeypatch):
    """The model's ``auto`` routes resolved as on a CUDA tensor: the region
    ops' and the dw op's CPU impls."""
    resolve = efficientnet.resolve_impl
    monkeypatch.setattr(efficientnet, "resolve_impl",
                        lambda impl, x: "kernel" if impl == "auto" else resolve(impl, x))


def _checked(cfg, seed=2**31 + 77, fault=None):
    tr = {**registry.traffic("train-efficientnet.b64"), "batch": 8, "pool_batches": 4}
    with efficientnet_fault(fault, cfg) if fault else contextlib.nullcontext():
        cell = driver.TrainCell(cfg, tr, seed, torch.device("cpu"))
        ours = cell.checked_steps()
    cell.free_program()
    return driver.gaps(ours, cell.reference())


@pytest.mark.parametrize("route", ["torch", "card"])
def test_three_train_steps_match_the_reference(route, request):
    """Three train steps of the cell's driver (the production step, the
    dropout and stochastic-depth mask from the seed, RMSProp, the external
    BN EMA) against the reference's: the losses, the first gradient, the
    parameters' change and the running statistics' change."""
    if route == "card":
        request.getfixturevalue("card_route")
    g = _checked(_small())
    assert g["loss_gap"] < 1e-5
    assert g["grad_gap_median"] < 1e-4 and g["change_gap_median"] < 1e-4
    assert g["grad_gap"] < 1e-3 and g["change_gap"] < 1e-3
    assert g["stat_gap_median"] < 1e-5 and g["stat_gap"] < 1e-4


@pytest.mark.parametrize("fault", ["silu_as_relu", "sd_ignored", "se_gate_one"])
def test_each_fault_fails_the_cells_comparison(fault, card_route):
    """The program broken underneath (the regions' SiLU as ReLU, the
    stochastic-depth mask ignored, the SE gate fixed at one) comes out not
    correct under the cell's own limits, on the card's route, at a width
    and depth whose sound run sits far inside them."""
    limits = registry.limits(CELL)
    cfg = _small(depth=1.0)
    sound = _checked(cfg)
    assert all(sound[k] <= lim["limit"] for k, lim in limits.items()), sound
    broken = _checked(cfg, fault=fault)
    assert any(broken[k] > lim["limit"] for k, lim in limits.items()), broken


def test_unsupported_knobs_raise():
    with pytest.raises(ValueError, match="remat"):
        create_model("efficientnet_b0", device="cpu", remat=True)
    with pytest.raises(ValueError, match="channel_pad"):
        create_model("efficientnet_b0", device="cpu", channel_pad=16)
    with pytest.raises(ValueError, match="unknown arch"):
        create_model("efficientnet_b9", device="cpu")
    from mnasnet_tpu_torch.models.layers import set_replicas
    from mnasnet_tpu_torch.parallel import Replicas

    model = _model(_small())
    set_replicas(model, Replicas(0, 1, "cpu"))
    with pytest.raises(ValueError, match="sync-BN"):
        model(torch.randn(1, 3, 32, 32))


def test_export_and_serve_on_the_cpu(tmp_path):
    """The serving export takes the arch name: the artifact, loaded by
    load_serving, gives the live eval forward's logits."""
    from mnasnet_tpu_torch.serving import load_serving
    from mnasnet_tpu_torch.tools.export_serving import build_forward, export_artifact

    t = time.perf_counter()
    fn, x = build_forward("efficientnet_b0", 10, "float32", None, 32, 2, raw_input=True,
                          device="cpu")
    predict = load_serving(export_artifact(fn, x), route="eager", device="cpu")
    img = torch.randint(0, 256, (2, 32, 32, 3), dtype=torch.uint8)
    with torch.no_grad():
        assert torch.equal(predict(img), fn(img))
    assert time.perf_counter() - t < 60
