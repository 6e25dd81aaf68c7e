"""The trace reader and the readers of the per-layer metrics, on a
synthetic trace."""

import pytest

from benchmark import counting, registry
from benchmark.harness import Reading
from benchmark.trace import WINDOW, Trace

MS = 1_000_000  # ns


def _events(units=2, mb_ms=0.5):
    """A window of ``units`` serving requests of 10 ms: a 1 ms copy in, one
    dw launch and 16 MBConv launches back to back, then 2 ms of nothing."""
    ev = [("span", WINDOW, 0, units * 10 * MS)]
    for u in range(units):
        t = u * 10 * MS
        ev.append(("span", "bench.predict", t, 7 * MS))
        ev.append(("span", "bench.copy_out", t + 7 * MS, 3 * MS))
        ev.append(("memcpy", "Memcpy HtoD (Pinned -> Device)", t, MS))
        ev.append(("kernel", "void dw_conv_kernel<bf16>", t + MS, MS // 2))
        at = t + MS + MS // 2
        for _ in range(16):
            ev.append(("kernel", "mbconv_tc_kernel", at, int(mb_ms * MS) // 16))
            at += int(mb_ms * MS) // 16
        ev.append(("kernel", "other", at, int((6.5 - mb_ms) * MS)))
        ev.append(("memcpy", "Memcpy DtoH (Device -> Pinned)", t + 8 * MS, 0))
    ev.append(("kernel", "outside", units * 10 * MS + 5, MS))  # after the window
    return ev


def test_bench_busy_gaps_and_spans():
    t = Trace(_events())
    assert t.window_s == pytest.approx(0.02)
    assert t.busy_s == pytest.approx(0.016)
    assert t.kernels(["mbconv_"]) == (32, pytest.approx(0.001))
    assert t.copies("HtoD") == (2, pytest.approx(0.002))
    assert t.idle_by_span() == [["bench.copy_out", pytest.approx(0.004)]]
    assert t.top_device_ops(1)[0][0] == "other"


def test_bench_window_by_launch_on_the_host_clock():
    """A device clock that runs ahead of the host's: the window's last
    launches read as ending after the host closed it, and a launch made
    before it reads as inside; each is placed by when it was launched."""
    skew = MS // 10
    ev = [("span", WINDOW, 10 * MS, 10 * MS),
          ("kernel", "mbconv_tc_kernel", 10 * MS - MS // 20 + skew, MS // 20, 9 * MS),
          ("kernel", "mbconv_tc_kernel", 15 * MS + skew, MS // 20, 14 * MS),
          ("kernel", "mbconv_tc_kernel", 20 * MS - MS // 20 + skew, MS // 20, 19 * MS),
          ("kernel", "outside", 20 * MS + skew, MS, None)]
    t = Trace(ev)
    assert t.kernels(["mbconv_"]) == (2, pytest.approx(0.0001))
    assert t.kernels(["outside"]) == (0, 0.0)
    assert t.busy_s == pytest.approx(0.00005)  # the late one falls past the window
    assert 0 < t.busy_s <= t.window_s


def _reading(trace, units, phase="serve", rate=None):
    cfg = registry.config("mnasnet1_0-224")
    out = {"e2e": {"serve_images_per_s": rate} if rate else {}, "phase": phase,
           "batch": 128, "trace": trace, "units": units}
    return Reading(registry.cell("serve.mnasnet1_0-224.b128"), cfg, out,
                   registry.kernel_families())


def test_bench_readers():
    r = _reading(Trace(_events()), 2, rate=25_000.0)
    read = {m: registry.metric_reader(m).read(r) for m in
            ("h2d_ms.serve", "device_idle.serve", "kernel_roofline.serve", "mfu.serve",
             "kernel_roofline.train", "mfu.train")}
    assert read["h2d_ms.serve"] == pytest.approx(1.0)
    assert read["device_idle.serve"] == pytest.approx(20.0)
    bound = (0.06134994149253732 + 0.11479449330045426) / 1e3
    assert read["kernel_roofline.serve"] == pytest.approx(100 * bound / 1.0e-3, rel=1e-3)
    assert read["mfu.serve"] == pytest.approx(
        100 * 2 * counting.count_macs(registry.config("mnasnet1_0-224")) * 25_000 / 989e12)
    assert read["kernel_roofline.train"] is None and read["mfu.train"] is None


def test_bench_roofline_is_silent_when_the_launches_do_not_match():
    ev = [e for e in _events() if not (e[1] == "mbconv_tc_kernel" and e[2] < 10 * MS
                                      and e[2] > 1.6 * MS)]
    r = _reading(Trace(ev), 2)
    assert registry.metric_reader("kernel_roofline.serve").read(r) is None


def test_bench_roofline_leaves_out_a_family_off_the_path():
    ev = [e for e in _events() if "dw_conv" not in e[1]]
    r = _reading(Trace(ev), 2)
    assert registry.metric_reader("kernel_roofline.serve").read(r) == pytest.approx(
        100 * 0.11479449330045426e-3 / 0.5e-3, rel=1e-3)
