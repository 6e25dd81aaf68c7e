"""What a run loads: no JAX, no JAX package, compared by whole top-level
names."""

import json
import subprocess
import sys

from benchmark import registry
from benchmark.run import forbidden_modules


def test_bench_whole_name_compare():
    assert forbidden_modules(["mnasnet_tpu_torch", "mnasnet_tpu_torch.serving", "jaxtyping",
                              "flaxen.x", "torch"]) == []
    assert forbidden_modules(["mnasnet_tpu.models", "jax._src", "jaxlib", "optax", "flax"]) \
        == ["flax", "jax", "jaxlib", "mnasnet_tpu", "optax"]


CHILD = """
import json, sys, time, torch
from benchmark.harness import run_cell
from benchmark.run import forbidden_modules
small = {"arch": "mnasnet0_35", "alpha": 0.35, "image_size": 32, "compute_dtype": "float32"}
for cell, tr in (("train.mnasnet1_0-224.b128", {"batch": 4, "pool_batches": 4, "warmup_seconds": 0}),
                 ("serve.mnasnet1_0-224.b128", {"batch": 2, "pool_batches": 2, "warmup_seconds": 0})):
    run_cell(cell, seed=3, seconds=0.2, trace=False, device=torch.device("cpu"),
             t0=time.perf_counter(), config_overrides=small, traffic_overrides=tr,
             log=lambda *a: None)
print(json.dumps(forbidden_modules()))
"""


def test_bench_a_run_loads_no_jax():
    """A whole run of a train and a serve cell at a small size on the CPU,
    the program and the reference included, in a fresh process."""
    out = subprocess.run([sys.executable, "-c", CHILD], cwd=registry.ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_bench_harness_sources_import_no_jax():
    for path in registry.HERE.rglob("*.py"):
        if path.name == "test_bench_imports.py":
            continue
        text = path.read_text()
        for bad in ("import jax", "from jax", "import flax", "from flax", "import optax",
                    "import mnasnet_tpu\n", "from mnasnet_tpu ", "from mnasnet_tpu.",
                    "import mnasnet_tpu."):
            assert bad not in text, (path, bad)
