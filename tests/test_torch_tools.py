"""The port's measurement tools (``mnasnet_tpu_torch/tools/{memory_probe,
bench_latency,export_latency,e2e_infer,sweep_grid}.py``) on the CPU, against
the reference where the reference has the same thing: the grid's parameter
and MAC counts against the JAX model's, the JPEG tree byte for byte against
``tools/e2e_infer.py``'s, ``--grad-accum 0``'s resolution against
``train.py:resolve_auto_grad_accum`` and ``auto_grad_accum``. Each tool's
``--device cpu`` run writes its keys (the card's null), and without a card
the default ``--device cuda`` exits non-zero. Alpha 0.35, at most 64 px.
"""

import importlib.util
import itertools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mnasnet_tpu.models.mnasnet import MNASNet as JaxMNASNet
from mnasnet_tpu.models.mnasnet import count_macs as jax_count_macs
from mnasnet_tpu.train.steps import auto_grad_accum as jax_auto_grad_accum
from mnasnet_tpu_torch.models.mnasnet import count_macs
from mnasnet_tpu_torch.tools import (
    bench_latency,
    e2e_infer,
    export_latency,
    memory_probe,
    sweep_grid,
)
from mnasnet_tpu_torch.train.steps import (
    CUDA_MICROBATCH_LIMIT,
    MICROBATCH_LIMIT,
    auto_grad_accum,
    resolve_auto_grad_accum,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CARD_INFO = {"tool", "device", "card", "nvidia_smi", "power_limit", "torch", "cuda"}
ALPHAS = (0.35, 0.5, 1.0)


def _reference(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run(tool, tmp_path, *argv) -> dict:
    out = tmp_path / f"{tool.__name__.rsplit('.', 1)[1]}.json"
    assert tool.main(["--device", "cpu", "--out", str(out), *argv]) == 0
    data = json.loads(out.read_text())
    assert CARD_INFO <= set(data)
    assert data["device"] == "cpu" and data["card"] is None and data["power_limit"] is None
    assert data["torch"] == torch.__version__
    return data


# ---- sweep_grid ------------------------------------------------------------

@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    return _run(sweep_grid, tmp_path_factory.mktemp("grid"),
                "--alphas", ",".join(map(str, ALPHAS)), "--sizes", "32", "--batch-size", "2",
                "--route", "eager")


@pytest.mark.parametrize("alpha", ALPHAS)
def test_sweep_grid_counts_are_the_reference_models(grid, alpha):
    row = next(r for r in grid["rows"] if r["alpha"] == alpha)
    shapes = jax.eval_shape(
        lambda: JaxMNASNet(alpha=alpha).init(jax.random.PRNGKey(0),
                                              jnp.zeros((1, 32, 32, 3)), train=False))
    jax_params = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes["params"]))
    assert row["params"] == jax_params
    assert row["macs"] == jax_count_macs(alpha, 32)
    assert row["refused"] == []
    # The counter itself over the whole published grid.
    for size in (96, 160, 224):
        assert count_macs(alpha, size) == jax_count_macs(alpha, size)


def test_sweep_grid_keys_on_the_cpu(grid):
    assert grid["kernel_slower_than_torch_at"] is None
    for row in grid["rows"]:
        assert row["arch"] == sweep_grid.arch_name(row["alpha"])
        for impl in ("kernel", "torch"):
            assert row[f"infer_{impl}_ips"] is None and row[f"infer_{impl}_ms"] is None
        assert row["fused_mbconv_blocks"] is None and row["dw_launches"] is None


def test_sweep_grid_names_the_shape_a_planner_refuses(monkeypatch):
    """Every width of the published grid is admitted; a block or a depthwise
    conv that a planner refuses is named with its planner and shape."""
    assert sweep_grid.refused_shapes(1.4, 224, 128) == []

    def dw_plan(n, h, w, c, k, s, eb):
        if c == 480:
            raise ValueError("no dw launch")

    monkeypatch.setattr(sweep_grid.dw_conv, "plan", dw_plan)
    monkeypatch.setattr(sweep_grid.mbconv, "mbconv_fits_smem",
                        lambda h, w, cin, cmid, cout, k, s, eb: cmid != 480)
    refused = sweep_grid.refused_shapes(1.0, 224, 128)
    assert {r["planner"] for r in refused} == {"dw_conv.plan", "mbconv_fits_smem"}
    assert [r["shape"] for r in refused if r["planner"] == "dw_conv.plan"] == \
        [[128, 14, 14, 480, 5, 1], [128, 14, 14, 480, 3, 1]]
    assert [r["block"] for r in refused if r["planner"] == "mbconv_fits_smem"] == \
        ["s2b1", "s2b2", "s3b0"]


# ---- e2e_infer -------------------------------------------------------------

def test_make_jpeg_tree_is_the_reference_byte_for_byte(tmp_path):
    ref = _reference("reference_e2e_infer", "tools/e2e_infer.py")
    ref.make_jpeg_tree(str(tmp_path / "ref"), 8)
    e2e_infer.make_jpeg_tree(str(tmp_path / "ours"), 8)
    ours = sorted(p.relative_to(tmp_path / "ours") for p in (tmp_path / "ours").rglob("*.jpg"))
    theirs = sorted(p.relative_to(tmp_path / "ref") for p in (tmp_path / "ref").rglob("*.jpg"))
    assert ours == theirs and len(ours) == 8
    for rel in ours:
        assert (tmp_path / "ours" / rel).read_bytes() == (tmp_path / "ref" / rel).read_bytes()


def test_e2e_infer_keys_on_the_cpu(tmp_path):
    data = _run(e2e_infer, tmp_path, "--arch", "mnasnet0_35", "--image-size", "32",
                "--batch-size", "4", "--n-images", "8", "--workers", "1,2",
                "--decoders", "pil", "--route", "eager", "--repeats", "1")
    assert data["device_only_ips"] is None and data["best"] is None
    assert [(r["decoder"], r["workers"]) for r in data["table"]] == [("pil", 1), ("pil", 2)]
    for row in data["table"]:
        assert row["e2e_ips"] is None and row["host_bound"] is None
        assert row["loader_only_ips"] > 0 and row["fallback_count"] == 0


# ---- --grad-accum 0 ---------------------------------------------------------

def test_auto_grad_accum_is_the_reference_at_the_limit():
    limit = CUDA_MICROBATCH_LIMIT or MICROBATCH_LIMIT
    assert [auto_grad_accum(b, limit) for b in range(1, 2049)] == \
        [jax_auto_grad_accum(b, limit) for b in range(1, 2049)]


@pytest.fixture(scope="module")
def reference_train():
    return _reference("train_cli", "train.py")


GRID = list(itertools.product((64, 128, 200, 250, 256, 384, 512, 1024, 2048), (1, 2, 8),
                              (True, False), (True, False)))


@pytest.mark.parametrize("backend", ["cuda", "cpu"])
def test_auto_rule_accumulating_side_is_the_reference_tpu_rule(reference_train, backend):
    """With a microbatch limit, CUDA resolves as the reference does on its TPU
    (sync-BN, fused updates and a batch that divides over the processes);
    the CPU never accumulates."""
    for batch, shards, sync_bn, fused in GRID:
        ours = resolve_auto_grad_accum(batch, shards, backend, sync_bn=sync_bn,
                                       fused_updates=fused, limit=MICROBATCH_LIMIT)
        theirs = reference_train.resolve_auto_grad_accum(
            batch, shards, "tpu" if backend == "cuda" else backend, sync_bn=sync_bn,
            fused_updates=fused)
        assert ours == theirs, (batch, shards, sync_bn, fused)
    assert resolve_auto_grad_accum(256, 1, backend, sync_bn=True, fused_updates=True,
                                   limit=MICROBATCH_LIMIT) == (2 if backend == "cuda" else 1)


@pytest.mark.parametrize("backend", ["cuda", "cpu"])
def test_auto_rule_as_measured(backend):
    """The rule as set from the H100 record: with no CUDA limit every batch
    takes the direct step; with one, the accumulating side above."""
    for batch, shards, sync_bn, fused in GRID:
        got = resolve_auto_grad_accum(batch, shards, backend, sync_bn=sync_bn,
                                      fused_updates=fused)
        want = (auto_grad_accum(batch // shards, CUDA_MICROBATCH_LIMIT)
                if backend == "cuda" and CUDA_MICROBATCH_LIMIT and sync_bn and fused
                and batch % shards == 0 else 1)
        assert got == want, (batch, shards, sync_bn, fused)


# ---- memory_probe -----------------------------------------------------------

@pytest.fixture(scope="module")
def probe(tmp_path_factory):
    return _run(memory_probe, tmp_path_factory.mktemp("probe"), "--arch", "mnasnet0_35",
                "--image-size", "64", "--batch-sizes", "16", "--accums", "1,2,4",
                "--min-microbatch", "4")


def test_memory_probe_saved_bytes_follow_the_microbatch(probe):
    rows = {r["grad_accum"]: r for r in probe["rows"]}
    assert sorted(rows) == [1, 2, 4]
    assert rows[2]["saved_activation_bytes"] <= 0.55 * rows[1]["saved_activation_bytes"]
    assert rows[4]["saved_activation_bytes"] <= 0.55 * rows[2]["saved_activation_bytes"]
    assert len({r["argument_bytes"] for r in rows.values()}) == 1
    assert len({r["saved_weight_cast_bytes"] for r in rows.values()}) == 1


def test_memory_probe_keys_on_the_cpu(probe):
    args = probe["argument_bytes"]
    assert args["total"] == args["params"] + args["buffers"] + args["optimizer"]
    assert args["optimizer"] > 0 and probe["auto_rule"] is None
    for row in probe["rows"]:
        assert row["microbatch"] * row["grad_accum"] == row["batch_size"]
        for key in ("ms_per_step", "images_per_s", "peak_allocated_gb", "peak_reserved_gb",
                    "launches_per_step", "oom"):
            assert row[key] is None


def test_memory_probe_auto_rule_needs_every_run_faster():
    def row(b, k, runs):
        return {"batch_size": b, "grad_accum": k, "ms_runs": runs, "images_per_s": 1.0,
                "peak_allocated_gb": 1.0}

    rows = [row(256, 1, [80.0, 81.0]), row(256, 2, [78.0, 79.5]),
            row(512, 1, [160.0, 161.0]), row(512, 4, [150.0, 151.0])]
    assert memory_probe.auto_rule(rows)["microbatch_limit"] == 128
    rows[1]["ms_runs"] = [78.0, 80.5]  # within the direct step's spread
    rule = memory_probe.auto_rule(rows)
    assert not rule["by_batch"]["256"]["accumulated_beats_direct"]
    assert rule["accumulate"] is False and rule["microbatch_limit"] is None
    assert memory_probe.plan([128, 512, 256], [1, 2, 4, 8], 64) == \
        [(256, [1, 2, 4]), (128, [1, 2]), (512, [1, 2, 4, 8])]


# ---- bench_latency and export_latency -----------------------------------------

def test_bench_latency_keys_on_the_cpu(tmp_path):
    data = _run(bench_latency, tmp_path, "--arch", "mnasnet0_35", "--image-size", "32",
                "--batches", "1,2", "--routes", "eager")
    assert [r["batch"] for r in data["table"]] == [1, 2]
    assert data["kernel_wins_at_batches"] is None and data["route_table_disagrees_at"] == []
    for row in data["table"]:
        for key in ("kernel_eager_ms", "torch_eager_ms", "kernel_ms", "kernel_speedup",
                    "agrees_with_table"):
            assert row[key] is None
        assert row["launches_per_forward"] == {"kernel": None, "torch": None}
        assert row["table_route"] == "graph"


def test_export_latency_artifact_is_bitwise_the_live_forward(tmp_path):
    data = _run(export_latency, tmp_path, "--arch", "mnasnet0_35", "--image-size", "32",
                "--batches", "1,3", "--routes", "eager")
    assert data["artifact"]["bytes"] > 0 and data["artifact"]["symbolic_batch"]
    assert data["artifact"]["export_seconds"] > 0 and data["artifact"]["load_seconds"] > 0
    assert [s["batch"] for s in data["by_batch"]] == [1, 3]
    for summary in data["by_batch"]:
        assert summary["eager_bitwise"] and summary["eager_max_abs_diff"] == 0.0
    for row in data["rows"]:
        assert row["route"] == "eager"
        assert row["live_ms"] is None and row["artifact_vs_live_pct"] is None


# ---- no card -------------------------------------------------------------------

@pytest.mark.parametrize("tool", [memory_probe, bench_latency, export_latency, e2e_infer,
                                  sweep_grid], ids=lambda t: t.__name__.rsplit(".", 1)[1])
def test_tool_refuses_a_missing_card(tool, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as e:
        tool.main(["--out", str(tmp_path / "x.json")])
    assert e.value.code == 2
    assert not (tmp_path / "x.json").exists()
