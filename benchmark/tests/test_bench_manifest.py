"""BENCHMARK.json against the contract's form, and every piece of every
cell found by its name."""

import json
import re
import shutil

import pytest

from benchmark import registry

BENCH = registry.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
CELLS = [c["name"] for c in BENCH["workloads"]]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_bench_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) for p in BENCH["paths"])
    assert not any(p.startswith("/") or ".." in p.split("/") for p in BENCH["paths"])
    assert 1 <= len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["configs"]) <= 24 and 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128


def test_bench_names_units_and_entries():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(BENCH["paths"][0] + "/") and PATH.match(c["file"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        names.append(("config", c["name"]))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic")) and _line(w["why"])
        assert w["chips"] in (1, 4)
        names.append(("cell", w["name"]))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
        names.append(("metric", m["name"]))
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_bench_metrics_and_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert _line(m["layer"]) and m["moves"] in e2e
        # Every cell that reports it reports the metric it moves.
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS and registry.applies(e2e[m["moves"]], cell)
        if m["unit"] == "%" and ("roofline" in m["name"] or "mfu" in m["name"]):
            assert m["better"] == "higher"


@pytest.mark.parametrize("cell", CELLS)
def test_bench_every_cell_reports_enough(cell):
    e2e = [m["name"] for m in BENCH["end_to_end"] if registry.applies(m, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(registry.applies(m, cell) for m in BENCH["per_layer"])


def test_bench_four_chip_cells_within_share():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("cell", CELLS)
def test_bench_cell_resolves_by_name(cell):
    c = registry.cell(cell)
    cfg = registry.config(c["config"])
    assert cfg["name"] == c["config"]
    listed = {x["name"]: x for x in BENCH["configs"]}[c["config"]]
    assert set(cfg["reduced"]) == set(listed["reduced"]) and cfg["source"] == listed["source"]
    tr = registry.traffic(c["traffic"])
    assert hasattr(registry.driver(tr["driver"]), "run")
    assert registry.limits(cell)
    for m in BENCH["per_layer"]:
        if registry.applies(m, cell):
            assert callable(registry.metric_reader(m["name"]).read)


def test_bench_every_config_has_a_cell_and_its_file():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert (registry.ROOT / c["file"]).is_file()


def test_bench_families_have_patterns_and_work():
    fams = registry.kernel_families()
    assert {"dw_conv", "mbconv", "bn_reduce", "bn_dx"} <= set(fams)
    for spec, mod in fams.values():
        assert spec["patterns"] and spec["peak"] in ("bfloat16", "float32")
        assert callable(mod.launches)


def test_bench_new_files_are_found_without_editing_any(tmp_path, monkeypatch):
    """A later cell brings its own traffic, limits, metric and kernel family
    as new files beside the others, and one more entry in BENCHMARK.json."""
    here = tmp_path / "benchmark"
    shutil.copytree(registry.HERE, here, ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "serve.mnasnet1_0-224.b64",
                               "config": "mnasnet1_0-224", "traffic": "serve.b64",
                               "chips": 1, "why": "a smaller batch"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    tr = json.loads((here / "traffic" / "serve.b128.json").read_text())
    (here / "traffic" / "serve.b64.json").write_text(json.dumps({**tr, "batch": 64}))
    (here / "limits" / "serve.mnasnet1_0-224.b64.json").write_text(
        (here / "limits" / "serve.mnasnet1_0-224.b128.json").read_text())
    (here / "metrics" / "copies.serve.py").write_text("def read(r):\n    return None\n")
    (here / "kernels" / "head.json").write_text(json.dumps(
        {"op": "head", "patterns": ["head_kernel"], "peak": "bfloat16", "what": "x"}))
    (here / "kernels" / "head.py").write_text("def launches(config, batch, phase):\n"
                                              "    return []\n")
    monkeypatch.setattr(registry, "HERE", here)
    monkeypatch.setattr(registry, "ROOT", tmp_path)
    cell = registry.cell("serve.mnasnet1_0-224.b64")
    assert registry.traffic(cell["traffic"])["batch"] == 64
    assert registry.limits(cell["name"])
    assert registry.metric_reader("copies.serve").read(None) is None
    assert "head" in registry.kernel_families()
