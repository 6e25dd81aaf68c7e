"""The EfficientNet squeeze-and-excitation kernels' family and its roofline
reader."""

import pytest

from benchmark import counting, registry
from benchmark.harness import Reading

B4 = registry.config("efficientnet_b4-380")
FAMILIES = registry.kernel_families()
KERNELS = ("se_pool_kernel", "se_scale_kernel", "se_dgate_kernel", "se_dx_kernel")


def _launches(cfg, batch, phase):
    return FAMILIES["se_efficientnet"][1].launches(cfg, batch, phase)


def test_bench_se_family_counts_b4():
    """32 launches of each of the four kernels a B4 step at batch 64, over
    1,251,081,216 elements (19,548,144 an image), 6 bytes an element forward
    and 8 backward in bf16: 2.243 and 2.988 ms at 3.35 TB/s."""
    spec, _ = FAMILIES["se_efficientnet"]
    assert tuple(spec["patterns"]) == KERNELS and spec["peak"] == "float32"
    got = _launches(B4, 64, "train")
    assert len(got) == 128
    assert {kind: sum(s[-1] == kind for s, _, _ in got)
            for kind in ("pool", "scale", "dgate", "dx")} == dict.fromkeys(
        ("pool", "scale", "dgate", "dx"), 32)
    elements = sum(b * h * w * c for (b, h, w, c, kind), _, _ in got if kind == "scale")
    assert elements == 64 * 19_548_144
    assert len({s[1:4] for s, _, _ in got}) == 12

    def ms(kinds):
        return 1e3 * sum(counting.bound_s(b, f, "float32") for s, b, f in got if s[-1] in kinds)

    assert ms(("pool", "scale")) == pytest.approx(2.2429, abs=1e-4)
    assert ms(("dgate", "dx")) == pytest.approx(2.9877, abs=1e-4)


@pytest.mark.parametrize("config,batch", [("mnasnet1_0-224", 128), ("mnasnet0_5-160", 256),
                                          ("efficientnet_b4-380", 64)])
@pytest.mark.parametrize("phase", ["train", "serve"])
def test_bench_se_family_is_silent_elsewhere(config, batch, phase):
    cfg = registry.config(config)
    assert (_launches(cfg, batch, phase) == []) == (config.startswith("mnasnet")
                                                     or phase == "serve")


def test_bench_se_patterns_match_no_other_familys_kernels():
    """No pattern of another family is found in an SE kernel's name, and
    the SE patterns are found in none of the other families' kernel names."""
    others = {name: spec["patterns"] for name, (spec, _) in FAMILIES.items()
              if name != "se_efficientnet"}
    for name, patterns in others.items():
        assert not any(p in k for p in patterns for k in KERNELS), name
        assert not any(k in p for p in patterns for k in KERNELS), name


class _Trace:
    """Each family's kernels ran its formula's count of times, each launch
    at twice its bound; ``without`` names families whose kernels did not
    run (the parent commit has no SE kernel)."""

    def __init__(self, cfg, batch, units, without=()):
        self.times = {}
        for name, (spec, mod) in FAMILIES.items():
            per = mod.launches(cfg, batch, "train")
            if per and name not in without:
                bound = sum(counting.bound_s(b, f, spec["peak"]) for _, b, f in per)
                self.times[tuple(spec["patterns"])] = (len(per) * units, 2 * bound * units)

    def kernels(self, patterns):
        return self.times.get(tuple(patterns), (0, 0.0))


def _reading(trace):
    cell = registry.cell("train.efficientnet_b4-380.b64")
    out = {"e2e": {"train_images_per_s": 600.0}, "phase": "train", "batch": 64,
           "trace": trace, "units": 10}
    return Reading(cell, B4, out, FAMILIES)


def test_bench_se_roofline_reads_its_family_alone():
    se = registry.metric_reader("kernel_roofline.se_efficientnet")
    b4 = registry.metric_reader("kernel_roofline.train_efficientnet")
    assert se.read(_reading(_Trace(B4, 64, 10))) == pytest.approx(50.0)
    assert b4.read(_reading(_Trace(B4, 64, 10))) == pytest.approx(50.0)
    # The parent's trace: no SE kernel ran, so nothing is read; the other
    # reader is unchanged.
    parent = _Trace(B4, 64, 10, without=("se_efficientnet",))
    assert se.read(_reading(parent)) is None
    assert b4.read(_reading(parent)) == pytest.approx(50.0)


def test_bench_se_roofline_entry():
    entry = next(m for m in registry.manifest()["per_layer"]
                 if m["name"] == "kernel_roofline.se_efficientnet")
    assert entry == {"name": "kernel_roofline.se_efficientnet", "unit": "%", "better": "higher",
                     "source": "device_trace", "layer": "kernels",
                     "moves": "train_images_per_s",
                     "workloads": ["train.efficientnet_b4-380.b64"]}
