"""The EfficientNet cell's frozen counting, kernel families and metrics."""

import pytest

from benchmark import counting, counting_efficientnet, harness, registry
from benchmark.harness import Reading

B4 = registry.config("efficientnet_b4-380")
FAMILIES = registry.kernel_families()
NEW = ("bn_stats_efficientnet", "bn_apply_silu", "bn_reduce_silu", "bn_dx_silu",
       "dw_conv_efficientnet")


@pytest.mark.parametrize("width,depth,size,macs", [(1.4, 1.8, 380, 4_393_771_024),
                                                   (1.0, 1.0, 224, 385_814_752)])
def test_bench_efficientnet_frozen_macs(width, depth, size, macs):
    """torchvision's 4.39 and 0.39 GFLOPS for B4 at 380 px and B0 at 224."""
    cfg = {**counting_efficientnet.family_config(B4, width, depth), "image_size": size}
    assert counting_efficientnet.count_macs(cfg) == macs


def test_bench_efficientnet_config_is_b4():
    """The file's widths and stages are B4's, in the keys MNASNet's frozen
    formulas read too."""
    fam = counting_efficientnet.family_config(B4, 1.4, 1.8)
    assert all(B4[k] == fam[k] for k in ("alpha", "base_depths", "first_stage_repeats",
                                         "stacks", "head_width"))
    assert counting_efficientnet.depths(B4) == [48, 24, 32, 56, 112, 160, 272, 448]
    assert counting.depths(B4) == counting_efficientnet.depths(B4)


def test_bench_kernel_shapes_run_on_the_new_config():
    lines = harness.kernel_shapes(B4, 64, "train", FAMILIES)
    assert any(line.startswith("shapes bn_dx_silu train") for line in lines)


@pytest.mark.parametrize("config,batch", [("mnasnet1_0-224", 128), ("mnasnet0_5-160", 256)])
@pytest.mark.parametrize("phase", ["train", "serve"])
def test_bench_new_families_are_silent_for_mnasnet(config, batch, phase):
    cfg = registry.config(config)
    assert all(FAMILIES[name][1].launches(cfg, batch, phase) == [] for name in NEW)


def test_bench_new_families_count_b4():
    got = {name: len(FAMILIES[name][1].launches(B4, 64, "train")) for name in NEW}
    assert got == {"bn_stats_efficientnet": 64, "bn_apply_silu": 64, "bn_reduce_silu": 64,
                   "bn_dx_silu": 64, "dw_conv_efficientnet": 32}
    assert all(FAMILIES[name][1].launches(B4, 64, "serve") == [] for name in NEW)


class _Trace:
    """A trace that ran each family's kernels its formula's count of times,
    each launch at twice its bound."""

    def __init__(self, cfg, batch, units):
        self.times = {}
        for name, (spec, mod) in FAMILIES.items():
            per = mod.launches(cfg, batch, "train")
            if per and name in NEW:
                bound = sum(counting.bound_s(b, f, spec["peak"]) for _, b, f in per)
                self.times[spec["patterns"][0]] = (len(per) * units, 2 * bound * units)

    def kernels(self, patterns):
        return self.times.get(patterns[0], (0, 0.0))


def test_bench_efficientnet_metrics_read_their_own_families():
    cell = registry.cell("train.efficientnet_b4-380.b64")
    out = {"e2e": {"train_images_per_s": 700.0}, "phase": "train", "batch": 64,
           "trace": _Trace(B4, 64, 10), "units": 10}
    r = Reading(cell, B4, out, FAMILIES)
    roofline = registry.metric_reader("kernel_roofline.train_efficientnet").read(r)
    assert roofline == pytest.approx(50.0)
    mfu = registry.metric_reader("mfu.train_efficientnet").read(r)
    assert mfu == pytest.approx(100 * 6 * 4_393_771_024 * 700.0 / 989e12)
    mn = Reading(registry.cell("train.mnasnet1_0-224.b128"), registry.config("mnasnet1_0-224"),
                 {**out, "batch": 128}, FAMILIES)
    assert registry.metric_reader("mfu.train_efficientnet").read(mn) is None


@pytest.mark.gpu
def test_bench_gpu_efficientnet_control_and_faults_fail():
    """On the card, at the cell's own size: the FP8 control and the three
    EfficientNet faults each fail the cell's limits, the program passes
    them (``test_bench_gpu.py`` dispatches only the drivers it knows)."""
    import torch

    from benchmark import calibrate_train

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = registry.cell("train.efficientnet_b4-380.b64")
    limits = registry.limits(cell["name"])
    got = calibrate_train.efficientnet_readings(B4, registry.traffic(cell["traffic"]),
                                                2**31 + 903, torch.device("cuda", 0), True, True)

    def fails(row):
        return any(row[k] > lim["limit"] for k, lim in limits.items())

    assert not fails(got["program"]), got["program"]
    for kind in ("control", "silu_as_relu", "sd_ignored", "se_gate_one", "half_batch",
                 "bn_leaves", "ema_unchanged", "unchanged"):
        assert fails(got[kind]), (kind, got[kind])
