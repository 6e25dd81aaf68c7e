"""The frozen counting: MACs, layer shapes, each kernel family's launches
and work."""

import pytest

from benchmark import counting, registry

FAMILIES = registry.kernel_families()


def _at(alpha: float, image: int) -> dict:
    """A configuration's file with another alpha and image size."""
    return {**registry.config("mnasnet1_0-224"), "alpha": alpha, "image_size": image}


@pytest.mark.parametrize("config,macs", [("mnasnet1_0-224", 314_415_872),
                                         ("mnasnet0_5-160", 53_920_800)])
def test_bench_frozen_macs(config, macs):
    assert counting.count_macs(registry.config(config)) == macs


@pytest.mark.parametrize("alpha,image", [(0.35, 96), (0.5, 160), (0.75, 192), (1.0, 224),
                                         (1.3, 224), (1.4, 224)])
def test_bench_frozen_copies_agree_with_the_program_today(alpha, image):
    """The frozen copies were taken from the program; a difference means one
    of them changed, and the yardstick must not follow the program."""
    from mnasnet_tpu_torch.models.mnasnet import count_macs, get_depths
    from mnasnet_tpu_torch.tools import tune_plans

    cfg = _at(alpha, image)
    assert counting.count_macs(cfg) == count_macs(alpha, image)
    assert counting.depths(cfg) == get_depths(alpha)
    assert counting.block_shapes(cfg) == tune_plans.block_shapes(alpha, image)
    assert counting.dw_shapes(cfg) == tune_plans.train_dw_shapes(alpha, image)
    assert counting.bn_region_shapes(cfg) == tune_plans.bn_region_shapes(alpha, image)


def test_bench_counting_follows_the_configs_widths():
    """The widths and stages are read from the configuration's file: one
    stage fewer is fewer MACs and launches, not the frozen count."""
    cfg = registry.config("mnasnet1_0-224")
    fewer = {**cfg, "stacks": cfg["stacks"][:-1], "base_depths": cfg["base_depths"][:-1]}
    assert counting.count_macs(fewer) < counting.count_macs(cfg)
    assert len(counting.block_shapes(fewer)) == len(counting.block_shapes(cfg)) - 1
    assert len(counting.bn_region_shapes(fewer)) == len(counting.bn_region_shapes(cfg)) - 2


@pytest.mark.parametrize("phase,expected", [
    ("serve", {"dw_conv": 1, "mbconv": 16, "bn_reduce": 0, "bn_dx": 0}),
    ("train", {"dw_conv": 17, "mbconv": 0, "bn_reduce": 35, "bn_dx": 35}),
])
def test_bench_launches_a_unit(phase, expected):
    cfg = registry.config("mnasnet1_0-224")
    got = {name: len(mod.launches(cfg, 128, phase)) for name, (_, mod) in FAMILIES.items()}
    assert {k: got[k] for k in expected} == expected


@pytest.mark.parametrize("phase,family,ms", [
    ("serve", "dw_conv", 0.061), ("serve", "mbconv", 0.115), ("train", "dw_conv", 0.362),
    ("train", "bn_reduce", 0.733), ("train", "bn_dx", 1.100)])
def test_bench_bounds_match_the_kernel_table(phase, family, ms):
    """Each family's bound over a forward or a step of mnasnet1_0@224 at
    bs128 is the sum PERF.md's kernel table gives (training dw: s1 0.254 +
    s2 0.108)."""
    spec, mod = FAMILIES[family]
    cfg = registry.config("mnasnet1_0-224")
    total = sum(counting.bound_s(b, f, spec["peak"]) for _, b, f in mod.launches(cfg, 128, phase))
    assert total * 1e3 == pytest.approx(ms, abs=0.0015)
